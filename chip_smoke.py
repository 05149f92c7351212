#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (micro_aes_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the main paths' shapes, checks published answers, then
serves single-key AES-GCM seal/open and CTR requests at 16 MiB, multi-key
batch GCM requests, bulk AES-GCM-SIV seal/open requests at 16 MiB, bulk
XTS disk-sector and OCB requests at 16 MiB, serial-chain (CBC, CFB, OFB,
CMAC) batch and per-message requests, one-pass AEAD (CCM, EAX, SIV) batch
requests, RFC 3394 key-wrap batch and per-message requests, Poly1305-AES,
FPE batch and per-token requests, the C-style compat surface and the sharded
paths (a process group of world size 1) through the public entry points, and
shows that each path ran through its kernels.

    python3 chip_smoke.py

Phases (each prints one line, with the seconds since the start; any
failure raises and exits non-zero):
  1 device     needs torch.cuda; prints the card's name and power limit
  2 build      nvcc of csrc/*.cu, one process per source (seconds,
               registers and spills per kernel)
  3 kernels    K1 (seal, open and on the transposed stream), K2 (encrypt
               and decrypt) and K3 vs their plain versions at the 16 MiB
               shapes, bit for bit, AES-128/192/256 (and K1/K3 across a
               counter wrap, K1 at W = 1, 33 and 257 with partial ghmask
               rows, both ways, and K1 on shards s = 1..3 of the 16 MiB
               message split SHARDS ways, at start = s*L - 1, both ways);
               times AES-256
  4 batch kernels
               K9's uniform cipher-and-xor on round keys prepared in advance
               (and through the JAX-contract wrapper; encrypt, decrypt) and
               K10 (seal, open) vs their plain versions at the batch path's
               shapes for 1024 keys x 16 KB (seal_batch._chain_shape,
               multikey.mk_window_words), AES-128 and AES-256, K10 across a
               counter carry into byte 9; times AES-128; K9's ragged entry
               on the mix of phase 15's ragged batch (256 messages, keys of
               16/24/32 B) in one launch each way vs its plain version
               (timed)
  5 GCM-SIV kernels
               K4 (and on the transposed stream), K5 (and transposed) and
               K5-open vs their plain versions at the 16 MiB shape
               (1,048,576 blocks, W = 32,800), bit for bit, AES-128 and
               -256, K5 and K5-open also with a counter base that wraps
               mid-stream, K5-open at W = 1, 33 and 257 with partial ghmask
               rows and a wrapping base, K4 (and transposed) at W = 1, 31,
               33, 257 and 300 with partial ghmask rows; times AES-256 and
               prints K5-open's bound both ways (level 1 on the tensor
               cores, and as INT32 gates, as its first design's bound
               counted it) and K4's three ways (its bytes, level 1 at the
               int8 tensor rate, level 1 as INT32 gates)
  6 XEX kernels
               K8 (cipher-and-xor), K6 (XTS body, a random base in every
               lane) and K7 (OCB body, nbits = 21 so that the last block
               selects L_20) vs their plain versions at the 16 MiB stream
               (W = 32,768), both directions, AES-128 and -256, and K6 at
               its offsets' edges (bases all-ones, word 3 = 0x80000000 or
               0xFFFFFFFF in every lane, W = 1 and 129), K7 at W = 1, 127,
               128, 129 and 300 with nbits from 0 to 32 and random lanes;
               times AES-256
  7 chain kernels
               K13's CBC, CFB and OFB (AES-256) and CBC-MAC (AES-128,
               nvalid from 0 to 256) vs their plain versions at 4096
               messages x 256 blocks (16 MiB), a random key per message,
               two lanes also vs the byte cipher's per-message scans; K13's
               ragged entry (CBC, CFB, OFB) at that shape as one run of
               words (the batches' launch; timed) vs the plain outputs, and
               on RAGGED_CHAIN_MIX (keys of 16/24/32 B, 2 to 256 blocks, a
               group of 33) in one launch each, vs its plain version and vs
               K13 run per group; times each kind and prints its latency
               floor
  8 AEAD chain kernels
               K11 (CCM and EAX, seal and open; AES-128 and -256) at 2048
               messages x 256 blocks and K12 (SIV seal and open, AES-128)
               at 4096 x 256 vs their plain versions, a random key per
               message, nvalid from 0 (SIV: 1) to 256, counter bases that
               carry into byte 9, K12 open(seal) as a round trip; each a
               call of two launches (K15's keystream pass and K13's MAC);
               then K15 with CCM's whitener and K13's MAC with the
               last-step constants vs their own plain versions; times
               AES-128 and prints each
               kind's latency floor
  9 wheel, wide-chain and CTR kernels
               K16 (KW wrap and unwrap, the natural and the wide map,
               AES-128 and -256) at 2048 messages x 64 semiblocks, K16's
               ragged entry there as one run of words (AES-128; timed) and
               on RAGGED_KW_MIX (KEKs of 16/24/32 B, n = 2, 3 and 64, a
               group of 33) in one launch each way, also vs K16 run per
               group, K14 (CBC, CFB, OFB in the wide map, AES-256)
               at 4096 x 256, also against K13 on the same messages, and
               K15 (AES-128, three counter bases that carry into byte 9) at
               4096 x 256, each vs its plain version, a key per message,
               and K15 at its edges (k15_edge_cases: windows that wrap, the
               whitener, nb = 1, 33, 130, 257, W = 1; each thread layout);
               times AES-128 (K14 AES-256) and prints K16's and K14's
               latency floors, and K9 (round keys) at K15's shape
 10 anchors    FIPS-197 through K2; McGrew-Viega GCM vectors through
               gcm_seal/gcm_open, gcm_encrypt/gcm_decrypt and, as batches,
               gcm_seal_batch (ragged and fast path); random messages
               against an oracle built from the byte cipher and the
               bit-serial GF(2^128) multiply; the main.c and RFC 8452
               GCM-SIV vectors through gcm_siv_encrypt/gcm_siv_decrypt; the
               main.c XTS vectors through xts_encrypt/xts_decrypt and a
               sector of the XTS256 key through xts_seal_sectors; the
               main.c and RFC 7253 OCB vectors through ocb_encrypt/
               ocb_decrypt and ocb_seal/ocb_open; main.c's CCM128, EAX128,
               EAXP128 and SIV128, RFC 5297 A.1 and the IEEE 1703 EAX'
               vectors per message
 11 requests  16 MiB AES-256 seal/open round trips with 1 KiB of AAD, one
               each for AES-128 and -192, a tampered tag, a CTR round trip and the
               K2-based v2 seal, each against the same pipeline run with
               the plain versions on the card; K1-K3 launches counted
 12 batch requests
               gcm_seal_batch/gcm_open_batch, AES-128 with 13-byte AADs, at
               1024 x 16 KB, 4096 x 4 KB and 64 x 256 KB (K10), one tampered
               tag, and a TLS-record-shaped ragged batch (K9): each against
               the same call with the plain versions on the card, samples
               against gcm_encrypt and gcm_seal; K9/K10 launches counted,
               K9 exactly (one ragged launch per ragged call, whatever its
               key sizes)
 13 GCM-SIV requests
               gcm_siv_seal/gcm_siv_open at 16 MiB: AES-256 under a new
               nonce, the same nonce again (warm) and a second new nonce,
               one AES-128 round trip, a tampered tag, each against the same
               pipeline run with the plain versions on the card, and
               samples of 4-64 KiB against gcm_siv_encrypt; new-nonce and
               warm latencies on the host clock; K4/K5/K5-open launches
               counted
 14 XTS and OCB requests
               AES-256-XTS xts_seal_sectors/xts_open_sectors of 16 MiB as
               4,096 x 4 KiB and as 32,768 x 512 B sectors (K6) and of 1 MiB
               of 4,160-byte sectors (the K2 fallback), integer LBAs; then
               AES-128-OCB ocb_seal/ocb_open of 16 MiB + 5 bytes with a
               12-byte nonce and 1 KiB of AAD (K7) and a tampered tag; each
               under a new and a warm key, against the same pipeline run
               with the plain versions on the card, and samples against
               xts_encrypt per sector and ocb_encrypt; K6/K7/K2 launches
               counted
 15 chain requests
               cbc_encrypt_batch (CTS)/cbc_decrypt_batch, cfb_*_batch and
               ofb_xcrypt_batch at 4096 x 4 KiB AES-256 and cmac_batch at
               4096 x 4 KiB AES-128, under a new and a warm key set; a
               ragged batch of 256 messages (AES-128/192/256 in turn, 0-4
               KiB, not whole blocks) through CBC-CTS, the three paddings,
               CFB, OFB, ECB, CTR and CMAC; the main.c ECB/CBC/CFB/OFB/CTR/
               CMAC answers and samples of the batches through the
               per-message API; the ragged batch and the 4096 x 4 KiB CBC
               and CMAC batches against the same call with the plain
               versions on the card; K13 launches counted exactly (one
               ragged launch per CBC/CFB/OFB batch call, one uniform launch
               per message) and K9's (one ragged launch per ECB, CTR or
               CBC/CFB decrypt batch call, two for CBC-CTS decrypt)
 16 AEAD requests
               ccm_*_batch and eax_*_batch at 2048 x 4 KiB (AES-128, 11- and
               12-byte nonces) and siv_*_batch at 4096 x 4 KiB (16 + 16-byte
               keys), AAD b"hdr", under a new and a warm key set, each with a
               tampered message; a ragged batch of 256 (AES-128/192/256 in
               turn, 0-4 KiB, empty and sub-block messages, AAD 0-40 B)
               through the three modes both ways; samples through the
               per-message API; each batch against the same call with the
               plain versions on the card; the K15 and K13 MAC launches
               counted exactly (per key size of each call: one of each,
               also tallied per K11/K12 operation, and the K13 folds of the
               MAC prefixes)
 17 KW requests
               key_wrap_batch/key_unwrap_batch: 2048 x 512 B secrets under
               AES-128 KEKs and 4,096 AES-256 data keys (32 B) under as many
               256-bit KEKs, each under a new and a warm key set with a
               tampered wrap; a ragged batch of 256 (KEKs of 16/24/32 bytes
               in turn, secrets of 16-512 B in steps of 8) both ways with a
               tampered wrap; main.c's KW128/192/256 and samples of the
               batches through key_wrap/key_unwrap; each batch against the
               same call with the plain versions on the card; K16 launches
               counted exactly (one ragged launch per batch call, one
               uniform launch per message)
 18 Poly1305, FPE and compat requests
               poly1305_aes of 16 MiB under an AES-256 key (routed to the
               bulk fold: float64 products on the card; new r and warm)
               against the module's host Horner loop, the fold's device time
               by CUDA events, a 64 KiB + 7 B message and main.c's
               POLY1305_128; fpe_encrypt_batch/fpe_decrypt_batch of 65,536
               sixteen-digit card numbers under FF1 (8-byte tweak) and FF3-1
               (7-byte tweak) and of 4,096 twenty-character alnum_lower
               tokens under FF1: every token round-trips, 64 a batch equal
               fpe_encrypt (FF1's PRF on K13, 10 launches a token), K2
               launches counted exactly per call (the PRF's batched
               encrypts), host-clock tokens per second; main.c's FF1 and
               FF3-1 through both paths; every compat function on the main.c
               vectors, with tampered tags and a short KW secret
 19 sharded    the sharded paths (parallel/) in a NCCL group of world size
               1 (a FileStore in a temporary directory, a finite timeout):
               gcm_sharded_fused_fn on a (1, 1) mesh for the `full` profile
               (16 MiB AES-256, 12-byte nonce, 1 KiB AAD), seal and open,
               against gcm_seal/gcm_open; the same message as SHARDS = 4
               shards in this process (the per-shard body on K1 at the
               shard counter offsets, the partials XORed on the card)
               against gcm_seal (one card checks the cross-shard algebra;
               ranks above 1 are checked only on the CPU, by
               tests/test_torch_parallel.py); gcm_seal_sharded_fn (K2) at 1
               MiB against gcm_seal; each dp twin at world size 1 against
               the unsharded batch API: seal_batch_sharded_fn (the
               matrix-GHASH core on K9's uniform entry) and
               gcm_chain_sharded_fn (K10) at 1024 x 16 KB AES-128, the XTS
               twin (K2, K6) at 4,096 x 4 KiB both ways, the chains (K13) at
               4096 x 4 KiB AES-256, CCM and EAX (K15, K13's MAC) at 2048 x
               4 KiB, SIV at 4096 x 4 KiB; each call's host clock beside the
               unsharded call's; every launch counted exactly
 20 launches   every kernel of the request paths launched in its requests
               phase, K6/K7 once per call and K2 once more per XTS call
               (twice per fallback call) and per FPE Feistel round; K8, K14,
               K16's wide map and K9's uniform entry are on no path of phases
               10-18, their counts read after phase 18 and required to be 0;
               K9's uniform entry then launches in phase 19 only, K8, K14 and
               K16's wide map nowhere

The output ends with a JSON line of per-kernel results, the nvidia-smi
line, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

MIB16_BLOCKS = 1 << 20  # 16 MiB: the repo's `full` bench profile
AAD_BYTES = 1024
TLS_AAD_BYTES = 13      # the TLS 1.2 record AAD
SEED = 0
# (keys, bytes per message): benchmarks.py's multi-key GCM rows
BATCH_SHAPES = ((1024, 16 << 10), (4096, 4 << 10), (64, 256 << 10))

# The least time of a kernel: the larger of its bytes over the HBM rate and
# its logic instructions over the INT32 issue rate.  H100 SXM: 3.35 TB/s;
# 132 SMs x 64 INT32 lanes x 1.98 GHz (half the lanes behind the data
# sheet's 67 TFLOP/s float32, which counts an FMA as two).  Instructions =
# the 2-input logic operations counted from csrc/ (below), halved: a LOP3
# does at most two.  Work on the tensor cores (K1's and K5-open's level 1,
# 1-bit AND and popcount) goes at the int8 dense peak, 1,979 TOP/s, the
# nearest rate the data sheet gives; the two units run side by side, so the
# larger counts.  K4, level 1 alone, runs faster than that rate on the card,
# so its bound leaves the binary products out.
HBM_BYTES_PER_S = 3.35e12
TENSOR_OPS_PER_S = 1.979e15
CLOCK_HZ = 1.98e9
INT32_PER_S = 132 * 64 * CLOCK_HZ
# The chain batches' shape (messages, blocks): benchmarks.py:756's AES-256 CBC
# chains, 4096 messages x 4 KiB, 16 MiB per call.
CHAIN_SHAPE = (4096, 256)
# K13's latency floor: a step of a chain is a whole cipher, and a round of it
# is at least the S-box's logic depth (28 two-input gates as written in
# csrc/aes_bitslice.cuh) plus MixColumns' 3 levels, paired by LOP3 into 16
# dependent instructions, and one shuffle: 88 cycles at 4 cycles per
# dependent instruction and 24 per shuffle (assumed Hopper latencies, not
# measured).
CHAIN_ROUND_CYCLES = 16 * 4 + 24
# The one-pass AEAD batches' shapes (messages, blocks): benchmarks.py:464-500's
# CCM/EAX rows, 2048 messages x 4 KiB, and benchmarks.py:620-666's SIV row,
# 4096 x 4 KiB.
AEAD_SHAPE = (2048, 256)
SIV_SHAPE = (4096, 256)
# K9's ragged mix: the size of phase 15's ragged batch (keys of 16/24/32 bytes
# in turn, 0..4 KiB), one launch of the ragged entry.
RAGGED_MK_MESSAGES = 256
# The KW wheel's shape (messages, semiblocks): benchmarks.py:637-648's
# AES-128 batch, 2048 secrets of 512 B.
KW_SHAPE = (2048, 64)
# Phase 18's shapes: a 16 MiB Poly1305-AES message (the `full` bench size,
# above the 64 KiB routing threshold, so it folds on the card); FPE batches of
# 65,536 card numbers of 16 digits (benchmarks.py:397-412's FF1 row: PCI
# tokenisation in the reference's default alphabet; more than FPE_CHUNK, so
# the chunked dispatch runs) and 4,096 twenty-character alnum_lower tokens
# (the unpacked wire); 64 tokens of each batch also through the host path.
POLY_BYTES = 16 << 20
FPE_TOKENS = (65536, 16)
FPE_ALNUM_TOKENS = (4096, 20)
FPE_HOST_SAMPLE = 64
# Phase 19's shapes: the 16 MiB message also as SHARDS shards of one process
# (phase 3 holds K1 at those shards' counter offsets), and the K2 sharded
# engine at 1 MiB; the XTS twin at phase 14's 4,096 sectors of 4 KiB.
SHARDS = 4
K2_SHARDED_BLOCKS = 1 << 16
XTS_SECTORS = (4096, 4096)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


_START = time.perf_counter()


def phase(n: int, name: str, text: str) -> None:
    """One phase's line, with the seconds since the script started (the
    whole run must stay inside its time limit)."""
    print(f"phase {n} {name} (t = {time.perf_counter() - _START:.1f} s): {text}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's `-Xptxas -v` output."""
    names = (("seal_fused_kernelILb1", "seal_fused<open>"),
             ("seal_fused_kernelILb0", "seal_fused<seal>"),
             ("cipher_planes_kernelILb1", "cipher_planes<decrypt>"),
             ("cipher_planes_kernelILb0", "cipher_planes<encrypt>"),
             ("ctr_fused_kernel", "ctr_fused"),
             ("multikey_kernelILb1", "multikey<decrypt>"),
             ("multikey_kernelILb0", "multikey<encrypt>"),
             ("chain_cipher_kernel", "gcm_chain<cipher>"),
             ("chain_fold_kernel", "gcm_chain<fold>"),
             ("ghash1_fused_kernel", "ghash1_fused"),
             ("siv_open_kernel", "siv_open"),
             ("siv_ctr_kernel", "siv_ctr"),
             ("StagedXorELb1", "ctrw_fused<decrypt>"),
             ("StagedXorELb0", "ctrw_fused<encrypt>"),
             ("AlphaOffsetsELb1", "xex_fused<decrypt>"),
             ("AlphaOffsetsELb0", "xex_fused<encrypt>"),
             ("GrayOffsetsELb1", "ocb_fused<decrypt>"),
             ("GrayOffsetsELb0", "ocb_fused<encrypt>"),
             ("chain_packed_kernelILi0", "chain_packed<cbc>"),
             ("chain_packed_kernelILi1", "chain_packed<cfb>"),
             ("chain_packed_kernelILi2", "chain_packed<ofb>"),
             ("chain_packed_kernelILi3", "chain_packed<cbc-mac>"),
             ("ctr_packed_kernelILi4", "ctr_packed<4 columns a thread>"),
             ("ctr_packed_kernelILi2", "ctr_packed<2 columns a thread>"),
             ("ctr_packed_kernelILi1", "ctr_packed<1 column a thread>"),
             ("kw_wheel_kernelILb0", "kw_wheel<wrap>"),
             ("kw_wheel_kernelILb1", "kw_wheel<unwrap>"))
    out, cur, spill = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            cur = next((short for key, short in names if key in ln), None)
        elif cur and "spill stores" in ln:
            spill = ln.strip()
        elif cur and "Used" in ln and "registers" in ln:
            out.append(f"{cur}: {ln.split('Used', 1)[1].strip()}; {spill}")
            cur, spill = None, ""
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls (CUDA events, after a
    warm-up call)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# -- logic operations, counted from csrc/ (2-input gates per 32-block group) --
TRANSPOSE32 = 5 * 16 * 6   # aes_bitslice.cuh transpose32
# K1 and K5-open XOR their keystream in the plane domain (xor_stream_row: the
# row into planes and back), since level 1 needs the stream's planes; K3
# and K5 need only the keystream as words and one XOR a word (ctr_xor_body)
XOR_ROW = 4 * (2 * TRANSPOSE32 + 32)
WORD_XOR = 4 * TRANSPOSE32 + 128
LEVEL1 = 2 * 128 * 128     # aes_bitslice.cuh level1_row: one AND+XOR per (output, plane)
LEVEL1_MMA = 2 * 128 * 4096  # level1_mma_warp (K1): an AND and an add per (output, bit)
# K4 (siv_fused.cu) a row: its words masked by ghm (128 ANDs), and W1p permuted
# to the word domain once per block of 256 rows (512 transposes)
K4_GATES = 128 + 512 * TRANSPOSE32 // 256
# GCM-SIV's counters (siv_fused.cu SivCounters) a row: word 0's planes + 32r,
# a 27-bit add (5 gates a bit), and the base's 4 transposes and 32 adds once
# per block of 128 rows
SIV_CTR = 27 * 5 + (4 * TRANSPOSE32 + 32) / 128
FOLD_STEP = 128 * 18       # gcm_chain.cu gf_mul: select, 4 AND-XOR, halving
ROW_IN_OUT = 8 * TRANSPOSE32 + 128   # a data row into planes and out, one XOR per word
# K6 and K7 count what their functions need, not a kernel's body: the offsets
# in the word domain and XORed onto the input (128 per row).  K6: base * alpha^jj
# of block jj as a shift across its four words (10 ops) and the 0x87 taps of the
# jj bits that fall out (14), for the 31 blocks with jj > 0.
XEX_OFFSETS = 31 * 24 + 128


def ocb_offset_gates(w: int, nbits: int) -> int:
    """K7's offsets as its table makes them (xex_fused.cu): per block of 128
    rows, each of its 128 lanes selects two start words over the nbits bits
    of gray (an AND and an XOR a bit), makes the 7 steps M_c and walks the
    127 other slots (an XOR each); then the input XOR (128 per row)."""
    return -(-w // 128) * 128 * (4 * nbits + 7 + 127) + 128 * w


def aes_gates(rounds: int, decrypt: bool = False) -> int:
    """One bitsliced AES of 32 blocks: S-boxes (115 gates forward, the
    derived inverse programs plus the shared 62-gate middle backward),
    MixColumns (528, InvMixColumns 352 more), AddRoundKey (128)."""
    from micro_aes_tpu_torch.core.bitslice import _INV_BOT_OPS, _INV_TOP_OPS

    sbox = len(_INV_TOP_OPS) + 62 + len(_INV_BOT_OPS) if decrypt else 115
    mix = 528 + (352 if decrypt else 0)
    return rounds * (16 * sbox + 128) + (rounds - 1) * mix + 128


def bound(nbytes: float, gates: float, tensor_ops: float = 0) -> tuple[float, str]:
    """(bound_ms, bound_by) from the bytes moved, the gates done and the
    tensor-core operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(gates / 2 / INT32_PER_S, tensor_ops / TENSOR_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


@contextlib.contextmanager
def plain_kernels():
    """Run the eight paths with the plain PyTorch versions in place of the
    kernels (the reference side of the requests phases)."""
    from micro_aes_tpu_torch.modes import (
        bulk,
        chain_bulk,
        common,
        kw,
        ocb_bulk,
        seal,
        seal_batch,
        siv_seal,
        xts_bulk,
    )
    from micro_aes_tpu_torch.ops import mac
    from micro_aes_tpu_torch.ops.aead_kernels import (
        aead_chain_fused_plain,
        siv_open_chain_fused_plain,
        siv_seal_chain_fused_plain,
    )
    from micro_aes_tpu_torch.ops.chain import gcm_chain_fused_plain
    from micro_aes_tpu_torch.ops.chain_kernels import (
        cbcmac_packed_fused_plain,
        chain_packed_fused_plain,
        chain_packed_ragged_plain,
        ofb_packed_fused_plain,
    )
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes_plain
    from micro_aes_tpu_torch.ops.kw_kernels import kw_packed_plain, kw_wheel_ragged_plain
    from micro_aes_tpu_torch.ops.multikey import cipher_blocks_ragged_plain
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused_plain, seal_fused_plain
    from micro_aes_tpu_torch.ops.siv_kernels import (
        ghash1_fused_plain,
        siv_ctrw_fused_plain,
        siv_open_fused_plain,
    )
    from micro_aes_tpu_torch.ops.xex_kernels import ocb_fused_plain, xex_fused_plain

    slots = ((seal, "seal_fused", seal_fused_plain), (seal, "ctr_fused", ctr_fused_plain),
             (seal, "cipher_planes", cipher_planes_plain),
             (seal_batch, "gcm_chain_fused_raw", gcm_chain_fused_plain),
             (bulk, "cipher_blocks_ragged", cipher_blocks_ragged_plain),
             (siv_seal, "ghash1_fused", ghash1_fused_plain),
             (siv_seal, "siv_ctrw_fused", siv_ctrw_fused_plain),
             (siv_seal, "siv_open_fused", siv_open_fused_plain),
             (xts_bulk, "xex_fused", xex_fused_plain),
             (xts_bulk, "cipher_planes", cipher_planes_plain),
             (ocb_bulk, "ocb_fused", ocb_fused_plain),
             (chain_bulk, "chain_packed_ragged", chain_packed_ragged_plain),
             (common, "chain_packed_fused", chain_packed_fused_plain),
             (common, "ofb_packed_fused", ofb_packed_fused_plain),
             (mac, "cbcmac_packed_fused", cbcmac_packed_fused_plain),
             (bulk, "aead_chain_fused", aead_chain_fused_plain),
             (bulk, "siv_seal_chain_fused", siv_seal_chain_fused_plain),
             (bulk, "siv_open_chain_fused", siv_open_chain_fused_plain),
             (bulk, "kw_wheel_ragged", kw_wheel_ragged_plain), (kw, "kw_packed", kw_packed_plain))
    saved = [getattr(mod, name) for mod, name, _ in slots]
    for mod, name, fn in slots:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(slots, saved):
            setattr(mod, name, fn)


def oracle_gcm(key: bytes, nonce: bytes, pt: bytes, aad: bytes) -> bytes:
    """AES-GCM from the byte-oriented cipher and the bit-serial GHASH
    multiply, block by block on the host (independent of the bulk path)."""
    import torch

    from micro_aes_tpu_torch.core.cipher import encrypt_blocks_np
    from micro_aes_tpu_torch.ops.gf128 import mul_gf128

    n = len(pt) // 16
    j0 = np.zeros(16, np.uint8)
    j0[:12] = np.frombuffer(nonce, np.uint8)
    j0[15] = 1
    ctrs = np.repeat(j0[None], n + 1, axis=0)
    low = (1 + np.arange(n + 1, dtype=np.uint64)) % (1 << 32)  # inc32
    ctrs[:, 12:] = low.astype(">u4").view(np.uint8).reshape(n + 1, 4)
    ks = encrypt_blocks_np(key, ctrs)
    ct = np.frombuffer(pt, np.uint8).reshape(n, 16) ^ ks[1:]
    h = torch.from_numpy(encrypt_blocks_np(key, np.zeros((1, 16), np.uint8))[0])
    apad = aad + bytes(-len(aad) % 16)
    lens = (8 * len(aad)).to_bytes(8, "big") + (8 * len(pt)).to_bytes(8, "big")
    blocks = np.frombuffer(apad + ct.tobytes() + lens, np.uint8).reshape(-1, 16)
    x = torch.zeros(16, dtype=torch.uint8)
    for b in torch.from_numpy(blocks.copy()):
        x = mul_gf128(h, x ^ b)
    return ct.tobytes() + bytes(x.numpy() ^ ks[0])


class Results:
    """Per-kernel errors, times and bounds, by the row names of the JSON
    line."""

    def __init__(self):
        self.errs: dict[str, int] = {}
        self.times: dict[str, dict] = {}

    def record(self, name, err, ms=None, plain_ms=None, nbytes=None, gates=None,
               tensor_ops=0):
        self.errs[name] = max(self.errs.get(name, 0), err)
        if ms is not None:
            bms, by = bound(nbytes, gates, tensor_ops)
            self.times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}

    def require_exact(self):
        check(all(e == 0 for e in self.errs.values()), f"kernel != plain version: {self.errs}")


def single_key_kernels(dev, rng, gen, res: Results):
    """Phase 3: K1-K3 against their plain versions at the 16 MiB shapes."""
    import torch

    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes, cipher_planes_plain
    from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
    from micro_aes_tpu_torch.ops.seal_kernels import (
        ctr_fused,
        ctr_fused_plain,
        seal_fused,
        seal_fused_plain,
        seal_fused_t,
    )

    def rand_words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    n = MIB16_BLOCKS
    w_seal = seal.seal_stream_words(n)
    w_ctr = seal.stream_words(n + 1)  # as ctr_bulk
    w_v2 = seal.stream_words(n + 2)   # as gcm_seal_kernel
    for klen in (32, 16, 24):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, tables = seal.gcm_key_setup(key, device=dev)
        kpf = kp.reshape(-1, 1)
        rounds = kp.shape[0] - 1
        j0 = seal._j0_block(rng.integers(0, 256, 12, dtype=np.uint8).tobytes(), dev)
        j0c, lohi = j0_planes(j0), lohi_words(j0, w_seal, -1)
        ghm = seal.ghash_mask(n, w_seal, dev)
        w1p = tables[5]
        pt = rand_words(w_seal, 128)
        timed = klen == 32  # the bulk path's key size
        line = [f"AES-{8 * klen}"]
        for opening in (False, True):
            ct_k, s1_k = seal_fused(kpf, j0c, lohi, ghm, w1p, pt, opening)
            ct_p, s1_p = seal_fused_plain(kpf, j0c, lohi, ghm, w1p, pt, opening)
            err = max(max_abs_err(ct_k, ct_p), max_abs_err(s1_k, s1_p))
            name = "seal_fused_open" if opening else "seal_fused"
            if timed:
                res.record(name, err,
                           cuda_ms(lambda: seal_fused(kpf, j0c, lohi, ghm, w1p, pt, opening), 10),
                           cuda_ms(lambda: seal_fused_plain(kpf, j0c, lohi, ghm, w1p, pt, opening), 3),
                           w_seal * (2 * 512 + 128), w_seal * (aes_gates(rounds) + XOR_ROW),
                           w_seal * LEVEL1_MMA)
            else:
                res.record(name, err)
            line.append(f"K1{' open' if opening else ''} err {err}")
        # K1 on the transposed [128, W] stream, held against the plain
        # version between the same transposes
        pt_t = pt.T.contiguous()

        def plain_t():
            out, s1 = seal_fused_plain(kpf, j0c, lohi, ghm, w1p, pt_t.T.contiguous())
            return out.T.contiguous(), s1

        ct_k, s1_k = seal_fused_t(kpf, j0c, lohi, ghm, w1p, pt_t)
        ct_p, s1_p = plain_t()
        err = max(max_abs_err(ct_k, ct_p), max_abs_err(s1_k, s1_p))
        if timed:
            res.record("seal_fused_t", err,
                       cuda_ms(lambda: seal_fused_t(kpf, j0c, lohi, ghm, w1p, pt_t), 10),
                       cuda_ms(plain_t, 3), w_seal * (2 * 512 + 128),
                       w_seal * (aes_gates(rounds) + XOR_ROW), w_seal * LEVEL1_MMA)
        else:
            res.record("seal_fused_t", err)
        line.append(f"K1t err {err}")
        planes = rand_words(8, 16, w_v2)
        for decrypt in (False, True):
            err = max_abs_err(cipher_planes(kp, planes, decrypt),
                              cipher_planes_plain(kp, planes, decrypt))
            name = "cipher_planes_dec" if decrypt else "cipher_planes"
            if timed:
                res.record(name, err, cuda_ms(lambda: cipher_planes(kp, planes, decrypt), 10),
                           cuda_ms(lambda: cipher_planes_plain(kp, planes, decrypt), 3),
                           w_v2 * 2 * 512, w_v2 * aes_gates(rounds, decrypt))
            else:
                res.record(name, err)
            line.append(f"K2{' dec' if decrypt else ''} err {err}")
        lohi_c = lohi_words(j0, w_ctr, -1)
        ptc = rand_words(w_ctr, 128)
        err = max_abs_err(ctr_fused(kpf, j0c, lohi_c, ptc), ctr_fused_plain(kpf, j0c, lohi_c, ptc))
        if timed:
            res.record("ctr_fused", err, cuda_ms(lambda: ctr_fused(kpf, j0c, lohi_c, ptc), 10),
                       cuda_ms(lambda: ctr_fused_plain(kpf, j0c, lohi_c, ptc), 3),
                       w_ctr * 2 * 512, w_ctr * (aes_gates(rounds) + WORD_XOR))
        else:
            res.record("ctr_fused", err)
        line.append(f"K3 err {err}")
        # a counter wrap: lo crosses 2^32 inside the stream, hi takes the carry
        jw = j0.clone()
        jw[12:16] = torch.tensor([0xFF, 0xFF, 0xF0, 0x01], dtype=torch.uint8)
        jw[9:12] = torch.tensor([0x12, 0xFF, 0xFF], dtype=torch.uint8)
        lw = lohi_words(jw, 256, -1)
        jwc = j0_planes(jw)
        gw, pw = rand_words(1, 256), rand_words(256, 128)
        a, b = seal_fused(kpf, jwc, lw, gw, w1p, pw), seal_fused_plain(kpf, jwc, lw, gw, w1p, pw)
        werr = max(max_abs_err(a[0], b[0]), max_abs_err(a[1], b[1]))
        res.record("seal_fused", werr)
        cerr = max_abs_err(ctr_fused(kpf, jwc, lw, pw), ctr_fused_plain(kpf, jwc, lw, pw))
        res.record("ctr_fused", cerr)
        line.append(f"wrap K1 err {werr} K3 err {cerr}")
        # K1 where W is not a multiple of 256 or of 32, with partial ghmask
        # rows (none, the low half, one block, all), both ways
        eerr = 0
        for we in (1, 33, 257):
            le, ge, pe = lohi_words(j0, we, -1), rand_words(1, we), rand_words(we, 128)
            for i, m in enumerate((0, 0x0000FFFF, -2**31, -1)):
                ge[0, (i * 7) % we] = m
            for opening in (False, True):
                a = seal_fused(kpf, j0c, le, ge, w1p, pe, opening)
                b = seal_fused_plain(kpf, j0c, le, ge, w1p, pe, opening)
                e = max(max_abs_err(a[0], b[0]), max_abs_err(a[1], b[1]))
                res.record("seal_fused_open" if opening else "seal_fused", e)
                eerr = max(eerr, e)
        line.append(f"K1 at W = 1/33/257 with partial masks err {eerr}")
        if timed:
            # K1 on the shards of the 16 MiB message split SHARDS ways, each
            # at its counter offset start = s*L - 1 (the sp-sharded seal)
            l = n // SHARDS
            w_l = seal.seal_stream_words(l)
            gl, serr = seal.ghash_mask(l, w_l, dev), 0
            for s in range(1, SHARDS):
                ls, ps = lohi_words(j0, w_l, s * l - 1), rand_words(w_l, 128)
                for opening in (False, True):
                    a = seal_fused(kpf, j0c, ls, gl, w1p, ps, opening)
                    b = seal_fused_plain(kpf, j0c, ls, gl, w1p, ps, opening)
                    e = max(max_abs_err(a[0], b[0]), max_abs_err(a[1], b[1]))
                    res.record("seal_fused_open" if opening else "seal_fused", e)
                    serr = max(serr, e)
            line.append(f"K1 at shard offsets s*{l} - 1 (s = 1..{SHARDS - 1}) err {serr}")
        # K3 where its last block of 128 rows is partly full
        kerr = 0
        for we in (1, 127, 128, 129, 300):
            le, pe = lohi_words(j0, we, -1), rand_words(we, 128)
            kerr = max(kerr, max_abs_err(ctr_fused(kpf, j0c, le, pe),
                                         ctr_fused_plain(kpf, j0c, le, pe)))
        res.record("ctr_fused", kerr)
        line.append(f"K3 at W = 1/127/128/129/300 err {kerr}")
        torch.cuda.synchronize()
        phase(3, "kernels", ", ".join(line))


def batch_kernels(dev, rng, gen, res: Results):
    """Phase 4: K9 and K10 against their plain versions at the batch
    path's shapes for 1024 keys x 16 KB."""
    import torch

    from micro_aes_tpu_torch.core.bitslice import key_planes_batch, key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.modes.seal_batch import _chain_shape
    from micro_aes_tpu_torch.ops.chain import (
        gcm_chain_fused_plain,
        gcm_chain_fused_raw,
        ghash_halving_table,
    )
    from micro_aes_tpu_torch.ops import multikey as mk
    from micro_aes_tpu_torch.ops.multikey import ctrw_fused_multikey, ctrw_fused_multikey_plain
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    def rand_words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    b, msg_bytes = BATCH_SHAPES[0]
    nb = msg_bytes // 16
    wm = mk.mk_window_words(nb + 1)  # the JAX contract's window of E(J0) and nb blocks
    bp, s, l = _chain_shape(b, nb)
    lanes = bp * s
    info = {"k9_rows": b * wm, "k10_lanes": lanes, "k10_steps": l}
    for klen in (16, 32):
        keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(bp)]
        rks = stack_round_keys(keys)
        rounds = rks.shape[1] - 1
        timed = klen == 16  # the batch rows' key size
        line = [f"AES-{8 * klen}"]
        rk_dev = torch.from_numpy(rks[:b]).to(dev)  # the round keys, prepared in advance
        kp_stack = key_planes_batch(rk_dev).reshape(-1, 1)
        ctr, pt = rand_words(b * wm, 128), rand_words(b * wm, 128)
        for decrypt in (False, True):
            want = ctrw_fused_multikey_plain(kp_stack, ctr, pt, b, decrypt)
            err = max(max_abs_err(mk.ctrw_multikey_rks(rk_dev, ctr, pt, b, decrypt), want),
                      max_abs_err(ctrw_fused_multikey(kp_stack, ctr, pt, b, decrypt), want))
            name = "multikey_dec" if decrypt else "multikey"
            if timed and not decrypt:
                # the function's work: the cipher, the counter rows in and the
                # data rows through their transposes
                res.record(name, err, cuda_ms(lambda: mk.ctrw_multikey_rks(rk_dev, ctr, pt, b), 10),
                           cuda_ms(lambda: ctrw_fused_multikey_plain(kp_stack, ctr, pt, b), 3),
                           b * wm * 3 * 512 + rks[:b].nbytes,
                           b * wm * (aes_gates(rounds) + 4 * TRANSPOSE32 + XOR_ROW))
            else:
                res.record(name, err)
            line.append(f"K9{' dec' if decrypt else ''} err {err}")
        kpw = u32_tensor(key_planes_packed(np.repeat(rks, s, 0)), dev)
        htab = ghash_halving_table(rand_u8(bp, 16).repeat_interleave(s, 0))
        c0 = rand_u8(lanes, 16)
        blocks = rand_u8(lanes, l, 16)
        ops = (kpw, htab, c0, rand_u8(lanes, 16), blocks, rand_words(l, lanes // 32),
               rand_words(l, lanes // 32), rand_words(l, lanes // 32),
               rand_words(l, lanes // 32), rand_u8(lanes, 16), rand_u8(lanes, 16))
        wrap = list(ops)
        wrap[2] = c0.clone()
        wrap[2][:, 9:16] = torch.tensor([0x00, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xF0],
                                        dtype=torch.uint8, device=dev)  # carries into byte 9
        for decrypt in (False, True):
            name = "gcm_chain_open" if decrypt else "gcm_chain"
            for args in (ops, wrap):
                got = gcm_chain_fused_raw(*args, decrypt=decrypt)
                want = gcm_chain_fused_plain(*args, decrypt=decrypt)
                res.record(name, max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1])))
            if timed and not decrypt:
                res.record(name, 0, cuda_ms(lambda: gcm_chain_fused_raw(*ops), 10),
                           cuda_ms(lambda: gcm_chain_fused_plain(*ops), 1),
                           2 * lanes * l * 16 + kpw.numel() * 4 + lanes * (16 * 5 + 16)
                           + 4 * l * lanes // 8,
                           lanes // 32 * l * (aes_gates(rounds) + 8 * TRANSPOSE32 + 128 + 32 * 6)
                           + lanes * l * FOLD_STEP)
            line.append(f"K10{' open' if decrypt else ''} err {res.errs[name]}")
        torch.cuda.synchronize()
        phase(4, "batch kernels", f"{', '.join(line)} ({json.dumps(info)})")
    phase(4, "batch kernels", ragged_multikey_kernels(dev, rng, gen, res))
    return info


def ragged_multikey_kernels(dev, rng, gen, res: Results) -> str:
    """K9's ragged entry on the mix of phase 15's ragged batch (256
    messages, keys of 16/24/32 bytes in turn, 1 to 257 blocks) in one
    launch each way against its plain version, with its descriptors from
    the host and already on the card; the encryption timed (descriptors on
    the card: the kernel, not the host's checks and copy); the decryption
    of the result must give the blocks back."""
    import torch

    from micro_aes_tpu_torch.ops import multikey as mk

    keys = [rng.integers(0, 256, (16, 24, 32)[i % 3], dtype=np.uint8).tobytes()
            for i in range(RAGGED_MK_MESSAGES)]
    nb = [(int(x) | 1) // 16 + 1 for x in rng.integers(0, 4096, RAGGED_MK_MESSAGES)]
    lay = mk.multikey_layout(keys, nb)
    rks = mk.layout_round_keys(keys, dev)
    blocks = torch.randint(0, 256, (lay.nblocks, 16), dtype=torch.uint8, device=dev,
                           generator=gen)
    # the valid blocks of each rounds group through the cipher and the
    # transposes in and out, 32 blocks to a group of gates
    gates = sum(int(lay.desc[lay.desc[:, 1] == r, 3].sum()) * (aes_gates(r) + 8 * TRANSPOSE32)
                for r in (10, 12, 14)) // 32
    desc = torch.from_numpy(lay.desc).to(dev)  # timed with its descriptors on the card
    errs = []
    for decrypt in (False, True):
        got = mk.cipher_blocks_ragged(rks, lay.desc, blocks, decrypt)
        want = mk.cipher_blocks_ragged_plain(rks, lay.desc, blocks, decrypt)
        errs.append(max(max_abs_err(got, want),
                        max_abs_err(mk.cipher_blocks_ragged(rks, desc, blocks, decrypt), want)))
        if not decrypt:
            check(torch.equal(mk.cipher_blocks_ragged(rks, lay.desc, got, True), blocks),
                  "K9 ragged: D(E(x)) != x")
            res.record("multikey_ragged", errs[-1],
                       cuda_ms(lambda: mk.cipher_blocks_ragged(rks, desc, blocks), 10),
                       cuda_ms(lambda: mk.cipher_blocks_ragged_plain(rks, lay.desc, blocks), 3),
                       2 * lay.nblocks * 16 + rks.numel() + lay.desc.nbytes, gates)
        else:
            res.record("multikey_ragged", errs[-1])
    torch.cuda.synchronize()
    return (f"K9 ragged ({RAGGED_MK_MESSAGES} messages, {lay.nblocks} blocks, "
            f"{lay.desc.shape[0]} rows, keys of 16/24/32 B, one launch each way) err "
            f"{max(errs)}, D(E(x)) = x")


def siv_kernels(dev, rng, gen, res: Results):
    """Phase 5: K4, K5 and K5-open (and K4/K5 on the transposed stream)
    against their plain versions at the 16 MiB GCM-SIV stream shape."""
    import torch

    from micro_aes_tpu_torch.modes import siv_seal
    from micro_aes_tpu_torch.modes.seal import position_mask
    from micro_aes_tpu_torch.ops.siv_kernels import (
        ghash1_fused,
        ghash1_fused_plain,
        ghash1_fused_t,
        siv_ctrw_fused,
        siv_ctrw_fused_plain,
        siv_ctrw_fused_t,
        siv_open_fused,
        siv_open_fused_plain,
    )

    def rand_words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    n = MIB16_BLOCKS
    w = siv_seal._stream_words(n)
    front = 32 * w - (n + 1)
    ghm_seal = position_mask(w, front, 32 * w, dev)
    ghm_open = position_mask(w, front, 32 * w - 1, dev)
    for klen in (32, 16):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
        _, kp, tables = siv_seal._siv_key_setup(key, nonce, dev)
        kpf, w1p, rounds = kp.reshape(-1, 1), tables[5], kp.shape[0] - 1
        basew = siv_seal._siv_basew(rand_words(4), front)
        # counter word 0 = 2^32 - 32 (w // 2) + position: wraps to 0 at the
        # first block of stream row w // 2
        wrap_basew = basew.clone()
        wrap_basew[0, 0::4] = -32 * (w // 2)
        x = rand_words(w, 128)
        x_t = x.T.contiguous()
        timed = klen == 32  # the bulk path's key size
        line = [f"AES-{8 * klen}"]

        def plain_t():
            return siv_ctrw_fused_plain(kpf, basew, x_t.T.contiguous()).T.contiguous()

        cases = (
            # K4: level 1 on the binary tensor cores, which run it faster than
            # the int8 rate (PERF.md), and no rate for them is published: its
            # binary products bound nothing, its bytes do
            ("ghash1_fused", lambda: ghash1_fused(ghm_seal, w1p, x),
             lambda: ghash1_fused_plain(ghm_seal, w1p, x), w * (512 + 128 + 4), w * K4_GATES),
            ("ghash1_fused_t", lambda: ghash1_fused_t(ghm_seal, w1p, x_t),
             lambda: ghash1_fused_plain(ghm_seal, w1p, x_t.T.contiguous()),
             w * (512 + 128 + 4), w * K4_GATES),
            ("siv_ctrw_fused", lambda: siv_ctrw_fused(kpf, basew, x),
             lambda: siv_ctrw_fused_plain(kpf, basew, x),
             w * 2 * 512, w * (aes_gates(rounds) + SIV_CTR + WORD_XOR)),
            ("siv_ctrw_fused_t", lambda: siv_ctrw_fused_t(kpf, basew, x_t), plain_t,
             w * 2 * 512, w * (aes_gates(rounds) + SIV_CTR + WORD_XOR)),
            # K5-open: level 1 on the tensor cores
            ("siv_open_fused", lambda: siv_open_fused(kpf, basew, ghm_open, w1p, x),
             lambda: siv_open_fused_plain(kpf, basew, ghm_open, w1p, x),
             w * (2 * 512 + 128 + 4), w * (aes_gates(rounds) + SIV_CTR + XOR_ROW),
             w * LEVEL1_MMA),
            ("siv_ctrw_fused", lambda: siv_ctrw_fused(kpf, wrap_basew, x),
             lambda: siv_ctrw_fused_plain(kpf, wrap_basew, x), None, None),
            ("siv_open_fused", lambda: siv_open_fused(kpf, wrap_basew, ghm_open, w1p, x),
             lambda: siv_open_fused_plain(kpf, wrap_basew, ghm_open, w1p, x), None, None),
        )
        for name, kernel, plain, nbytes, gates, *tensor_ops in cases:
            got, want = kernel(), plain()
            if isinstance(got, tuple):
                err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
            else:
                err = max_abs_err(got, want)
            if timed and nbytes is not None:
                res.record(name, err, cuda_ms(kernel, 10), cuda_ms(plain, 3), nbytes, gates,
                           *tensor_ops)
            else:
                res.record(name, err)
            line.append(f"{name}{'' if nbytes else ' wrap'} err {err}")
        # K5 and K5-open with a base of random lanes and one whose lanes wrap
        # on their own (basew[4j] = 2^32 - 1 - j mod 7)
        lanes16 = rand_words(1, 128)
        lane_wrap16 = lanes16.clone()
        lane_wrap16[0, 0::4] = -1 - torch.arange(32, device=dev, dtype=torch.int32) % 7
        lerr = 0
        for base in (lanes16, lane_wrap16):
            k = max_abs_err(siv_ctrw_fused(kpf, base, x), siv_ctrw_fused_plain(kpf, base, x))
            res.record("siv_ctrw_fused", k)
            a = siv_open_fused(kpf, base, ghm_open, w1p, x)
            b = siv_open_fused_plain(kpf, base, ghm_open, w1p, x)
            e = max(max_abs_err(a[0], b[0]), max_abs_err(a[1], b[1]))
            res.record("siv_open_fused", e)
            lerr = max(lerr, k, e)
        line.append(f"siv_ctrw_fused/siv_open_fused with random and self-wrapping lanes err {lerr}")
        if timed:  # K4's and K5-open's bounds with level 1 as INT32 gates, as first run
            gates_l1 = w * (aes_gates(rounds) + SIV_CTR + XOR_ROW + LEVEL1)
            line.append(f"siv_open_fused bound {res.times['siv_open_fused']['bound_ms']:.4f} ms "
                        f"(level 1 on the tensor cores; "
                        f"{bound(w * (2 * 512 + 128 + 4), gates_l1)[0]:.4f} ms as INT32 gates)")
            k4_bytes = w * (512 + 128 + 4)
            line.append(f"ghash1_fused bound {res.times['ghash1_fused']['bound_ms']:.4f} ms "
                        f"(its bytes; "
                        f"{bound(k4_bytes, w * K4_GATES, w * LEVEL1_MMA)[0]:.4f} ms with level "
                        f"1 at the int8 tensor rate, "
                        f"{bound(k4_bytes, w * (4 * TRANSPOSE32 + LEVEL1))[0]:.4f} ms as INT32 "
                        f"gates)")
        # K4 (and K4 on the transposed stream) where W is not a multiple of
        # 256 or of 32, with partial ghmask rows (none, the low half, one
        # block, all)
        kerr = 0
        for we in (1, 31, 33, 257, 300):
            ge, xe = rand_words(1, we), rand_words(we, 128)
            for i, m in enumerate((0, 0x0000FFFF, -2**31, -1)):
                ge[0, (i * 7) % we] = m
            want = ghash1_fused_plain(ge, w1p, xe)
            e = max(max_abs_err(ghash1_fused(ge, w1p, xe), want),
                    max_abs_err(ghash1_fused_t(ge, w1p, xe.T.contiguous()), want))
            res.record("ghash1_fused", e)
            kerr = max(kerr, e)
        line.append(f"ghash1_fused at W = 1/31/33/257/300 with partial masks err {kerr}")
        # K5 and K5-open where W is not a multiple of their blocks' rows (128,
        # 256) or of 32, with partial ghmask rows (none, the low half, one
        # block, all), and three bases: random lanes, a word 0 that wraps
        # inside row W // 2 (and so across rows), and lanes where basew[4j] + j
        # itself wraps for j >= 7 (basew[4j] = 2^32 - 1 - j mod 7)
        eerr = 0
        for we in (1, 33, 127, 128, 129, 257, 300):
            ge, xe = rand_words(1, we), rand_words(we, 128)
            for i, m in enumerate((0, 0x0000FFFF, -2**31, -1)):
                ge[0, (i * 7) % we] = m
            lanes = rand_words(1, 128)
            we_wrap = lanes.clone()
            we_wrap[0, 0::4] = -32 * (we // 2) - 5
            lane_wrap = lanes.clone()
            lane_wrap[0, 0::4] = -1 - torch.arange(32, device=dev, dtype=torch.int32) % 7
            for base in (lanes, we_wrap, lane_wrap):
                a = siv_open_fused(kpf, base, ge, w1p, xe)
                b = siv_open_fused_plain(kpf, base, ge, w1p, xe)
                e = max(max_abs_err(a[0], b[0]), max_abs_err(a[1], b[1]))
                res.record("siv_open_fused", e)
                k = max_abs_err(siv_ctrw_fused(kpf, base, xe), siv_ctrw_fused_plain(kpf, base, xe))
                res.record("siv_ctrw_fused", k)
                eerr = max(eerr, e, k)
        line.append(f"siv_ctrw_fused and siv_open_fused at W = 1/33/127/128/129/257/300 with "
                    f"partial masks, random lanes and wraps err {eerr}")
        torch.cuda.synchronize()
        phase(5, "GCM-SIV kernels", f"W={w}, " + ", ".join(line))


def xex_kernels(dev, rng, gen, res: Results):
    """Phase 6: K8, K6 and K7 against their plain versions at the 16 MiB
    stream, both directions."""
    import torch

    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops.xex_kernels import (
        ctrw_fused,
        ctrw_fused_plain,
        ocb_fused,
        ocb_fused_plain,
        xex_fused,
        xex_fused_plain,
    )

    def rand_words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    w = MIB16_BLOCKS // 32
    nbits = (32 * w).bit_length()  # block indices 1..2^20: the last selects L_20
    for klen in (32, 16):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, _ = seal.gcm_key_setup(key, device=dev)
        kpf, rounds = kp.reshape(-1, 1), kp.shape[0] - 1
        x, y = rand_words(w, 128), rand_words(w, 128)  # y: the K8 blocks, the K6 bases
        d0l, lbl = rand_words(1, 128), rand_words(nbits, 128)
        timed = klen == 32
        line = [f"AES-{8 * klen}"]
        for decrypt in (False, True):
            suffix = "_dec" if decrypt else ""
            aes = aes_gates(rounds, decrypt)
            cases = (
                ("ctrw_fused", lambda: ctrw_fused(kpf, y, x, decrypt),
                 lambda: ctrw_fused_plain(kpf, y, x, decrypt), w * 3 * 512, w * (aes + ROW_IN_OUT)),
                ("xex_fused", lambda: xex_fused(kpf, y, x, decrypt),
                 lambda: xex_fused_plain(kpf, y, x, decrypt), w * 3 * 512,
                 w * (aes + ROW_IN_OUT + XEX_OFFSETS)),
                ("ocb_fused", lambda: ocb_fused(kpf, d0l, lbl, x, nbits, decrypt),
                 lambda: ocb_fused_plain(kpf, d0l, lbl, x, nbits, decrypt),
                 w * 2 * 512 + (nbits + 1) * 512,
                 w * (aes + ROW_IN_OUT) + ocb_offset_gates(w, nbits)),
            )
            for name, kernel, plain, nbytes, gates in cases:
                err = max_abs_err(kernel(), plain())
                if timed:
                    res.record(name + suffix, err, cuda_ms(kernel, 10), cuda_ms(plain, 3),
                               nbytes, gates)
                else:
                    res.record(name + suffix, err)
                line.append(f"{name}{suffix} err {err}")
        # K6 at the offsets' edges: bases all-ones, and word 3 = 0x80000000
        # or 0xFFFFFFFF in every lane (every block jj > 0 overflows, and for
        # jj > 25 the fold reaches word 1), at W = 1 and 129 (not a multiple
        # of the block's rows), both directions
        eerr = 0
        for we in (1, 129):
            xe = rand_words(we, 128)
            for top in (None, -2**31, -1):
                be = rand_words(we, 128)
                if top is None:
                    be.fill_(-1)
                else:
                    be[:, 3::4] = top
                for decrypt in (False, True):
                    e = max_abs_err(xex_fused(kpf, be, xe, decrypt),
                                    xex_fused_plain(kpf, be, xe, decrypt))
                    res.record("xex_fused_dec" if decrypt else "xex_fused", e)
                    eerr = max(eerr, e)
        line.append(f"xex_fused edges (W = 1/129, bases all-ones, word 3 = 0x80000000 or "
                    f"0xFFFFFFFF; both ways) err {eerr}")
        # K7 where W is under, at and over the block's 128 rows (its table's
        # walk, and block 31 of a block's last row) and nbits runs from 0 to
        # 32, random lanes, both directions
        oerr = 0
        for we in (1, 127, 128, 129, 300):
            xe, de, le = rand_words(we, 128), rand_words(1, 128), rand_words(32, 128)
            for nb in (0, 1, 5, 6, 12, 21, 32):
                for decrypt in (False, True):
                    e = max_abs_err(ocb_fused(kpf, de, le, xe, nb, decrypt),
                                    ocb_fused_plain(kpf, de, le, xe, nb, decrypt))
                    res.record("ocb_fused_dec" if decrypt else "ocb_fused", e)
                    oerr = max(oerr, e)
        line.append(f"ocb_fused at W = 1/127/128/129/300 and nbits = 0/1/5/6/12/21/32 "
                    f"(both ways) err {oerr}")
        torch.cuda.synchronize()
        phase(6, "XEX kernels", f"W={w}, nbits={nbits}, " + ", ".join(line))


def chain_kernels(dev, rng, gen, res: Results):
    """Phase 7: K13's CBC and CFB (AES-256), OFB (AES-256) and CBC-MAC
    (AES-128, nvalid from 0 to nb) against their plain versions at the chain
    batches' shape, 4096 messages x 256 blocks (16 MiB), a random key per
    message; lanes 0 and B-1 also against the byte cipher's per-message
    scans.  Returns the latency floors (ms) per kind."""
    import torch

    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes import _scan
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops.mac import cbcmac_fold
    from micro_aes_tpu_torch.ops.ragged import ragged_layout
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    b, nb = CHAIN_SHAPE
    w = b // 32

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    ivs, blocks = rand_u8(b, 16), rand_u8(b, nb, 16)
    nv = rng.integers(0, nb + 1, b).astype(np.int32)
    nv[:2] = (0, nb)
    nvalid = torch.from_numpy(nv).to(dev)
    rks, kpw = {}, {}
    for klen in (32, 16):
        rks[klen] = stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                      for _ in range(b)])
        kpw[klen] = u32_tensor(key_planes_packed(rks[klen]), dev)
    blk = b * nb * 16
    cases = (  # name, key size, kernel, plain, bytes, gates, steps on the critical path
        ("chain_packed", 32, lambda: ck.chain_packed_fused("cbc", kpw[32], ivs, blocks),
         lambda: ck.chain_packed_fused_plain("cbc", kpw[32], ivs, blocks),
         2 * blk + b * 16 + kpw[32].numel() * 4, w * nb * (aes_gates(14) + 128), nb),
        ("chain_packed_cfb", 32, lambda: ck.chain_packed_fused("cfb", kpw[32], ivs, blocks),
         lambda: ck.chain_packed_fused_plain("cfb", kpw[32], ivs, blocks),
         2 * blk + b * 16 + kpw[32].numel() * 4, w * nb * (aes_gates(14) + 128), nb),
        ("ofb_packed", 32, lambda: ck.ofb_packed_fused(kpw[32], ivs, nb),
         lambda: ck.ofb_packed_fused_plain(kpw[32], ivs, nb),
         blk + b * 16 + kpw[32].numel() * 4, w * nb * aes_gates(14), nb),
        ("cbcmac_packed", 16, lambda: ck.cbcmac_packed_fused(kpw[16], ivs, blocks, nvalid),
         lambda: ck.cbcmac_packed_fused_plain(kpw[16], ivs, blocks, nvalid),
         blk + b * (16 + 4 + 16) + kpw[16].numel() * 4,
         int(nv.sum()) * (aes_gates(10) + 3 * 128) // 32, int(nv.max())),
    )
    floors, line, wants = {}, [], {}
    for name, klen, kernel, plain, nbytes, gates, steps in cases:
        got = kernel()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = wants[name] = plain()
        end.record()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        res.record(name, err, cuda_ms(kernel, 10), start.elapsed_time(end), nbytes, gates)
        rounds = 14 if klen == 32 else 10
        floors[name] = 1e3 * steps * rounds * CHAIN_ROUND_CYCLES / CLOCK_HZ
        line.append(f"{name} AES-{8 * klen} err {err}")
        for i in (0, b - 1):  # a lane against the byte cipher, one block per step
            rk, iv = torch.from_numpy(rks[klen][i]).to(dev), ivs[i]
            if name == "chain_packed":
                ref = _scan.cbc_encrypt_scan(rk, iv, blocks[i])
            elif name == "chain_packed_cfb":
                ref = _scan.cfb_encrypt_scan(rk, iv, blocks[i])
            elif name == "ofb_packed":
                ref = _scan.ofb_keystream_scan(rk, iv, nb)
            else:
                ref = cbcmac_fold(rk, iv, blocks[i], int(nv[i]))
            check(torch.equal(got[i], ref), f"{name} lane {i} != the per-message scan")
    # the ragged entry at this shape: one run of 128 words in batch order, the
    # launch of the 4096 x 4 KiB batches, against the plain outputs above;
    # CBC also against the ragged plain version, both timed
    lay = ragged_layout([nb] * b, [14] * b, [16 * nb] * b)
    check(np.array_equal(lay.order, np.arange(b)), "K13 ragged: a one-run layout reorders")
    flat = blocks.reshape(-1)
    for kind, name in (("cbc", "chain_packed"), ("cfb", "chain_packed_cfb"), ("ofb", "ofb_packed")):
        args = (kind, kpw[32], lay.desc, ivs) + ((None, blk) if kind == "ofb" else (flat,))
        got = ck.chain_packed_ragged(*args)
        err = max_abs_err(got, wants[name].reshape(-1))
        if kind == "cbc":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = max(err, max_abs_err(got, ck.chain_packed_ragged_plain(*args)))
            end.record()
            torch.cuda.synchronize()
            res.record("chain_packed_ragged", err, cuda_ms(lambda: ck.chain_packed_ragged(*args), 10),
                       start.elapsed_time(end), 2 * blk + b * 16 + kpw[32].numel() * 4
                       + lay.desc.nbytes, w * nb * (aes_gates(14) + 128))
        else:
            res.record("chain_packed_ragged", err)
        line.append(f"chain_packed_ragged {kind} at {b} x {nb} err {err}")
    line.append(ragged_chain_kernels(dev, rng, res))
    floors["chain_packed_ragged"] = 1e3 * nb * 14 * CHAIN_ROUND_CYCLES / CLOCK_HZ
    torch.cuda.synchronize()
    phase(7, "chain kernels", f"{b} messages x {nb} blocks, a key per message, nvalid "
          f"{int(nv.min())}..{int(nv.max())} (mean {nv.mean():.1f}); plain versions timed "
          f"once at the full shape; lanes 0 and {b - 1} equal the byte cipher's scans; "
          + ", ".join(line) + "; latency floors (ms) " + json.dumps(floors))
    return floors


# The ragged mixes of phases 7 and 9: (key bytes, steps, messages) groups in
# one launch, steps being K13's blocks or K16's semiblocks n.  Each holds a
# group of 33 messages (two words that differ only in padding), key sizes 16,
# 24 and 32 at 2, 3 and 64 steps, and for K13 the chain batches' 256 blocks
# at AES-256 (the longest word, which sets the launch's time).
RAGGED_CHAIN_MIX = ((32, 64, 33), *((k, n, 5) for k in (16, 24, 32) for n in (2, 3, 64)),
                    (32, 256, 7))
RAGGED_KW_MIX = ((16, 64, 33), *((k, n, 5) for k in (16, 24, 32) for n in (2, 3, 64)))


def ragged_keys(rng, mix):
    """(keys, steps) of a ragged mix, in an interleaved batch order."""
    keys, steps = [], []
    for klen, n, count in mix:
        keys += [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(count)]
        steps += [n] * count
    perm = rng.permutation(len(keys))
    return [keys[i] for i in perm], [steps[i] for i in perm]


def per_group(keys, steps, run):
    """run(idxs, kpw) for each (steps, key size) group, kpw the group's key
    planes padded to 32 lanes (zero keys) -> {message index: its output}."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys

    out = {}
    for n, klen in sorted({(n, len(k)) for k, n in zip(keys, steps)}):
        idxs = [i for i in range(len(keys)) if steps[i] == n and len(keys[i]) == klen]
        rks = stack_round_keys([keys[i] for i in idxs])
        rks = np.concatenate([rks, np.zeros(((-len(idxs)) % 32,) + rks.shape[1:], np.uint8)])
        out.update(zip(idxs, run(idxs, key_planes_packed(rks))))
    return out


def ragged_chain_kernels(dev, rng, res: Results) -> str:
    """K13's ragged entry (CBC, CFB, OFB) on RAGGED_CHAIN_MIX in one launch
    each, against its plain version and against K13's uniform entry run per
    (blocks, key size) group; times CBC for the phase line (the kernels
    line's time is phase 7's, at the batches' shape).  Returns the phase
    line's part."""
    import torch

    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops.ragged import layout_key_planes, ragged_layout
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    keys, steps = ragged_keys(rng, RAGGED_CHAIN_MIX)
    lay = ragged_layout(steps, [len(k) // 4 + 6 for k in keys], [16 * n for n in steps])
    kpw = layout_key_planes(keys, lay, dev)
    ivs = rng.integers(0, 256, (len(keys), 16), dtype=np.uint8)
    data = [rng.integers(0, 256, 16 * n, dtype=np.uint8) for n in steps]
    iv_t = torch.from_numpy(ivs[lay.order]).to(dev)
    blocks = torch.from_numpy(np.concatenate([data[i] for i in lay.order])).to(dev)
    errs = []
    for kind in ("cbc", "cfb", "ofb"):
        args = (kind, kpw, lay.desc, iv_t) + ((None, lay.nbytes) if kind == "ofb" else (blocks,))
        before = ck.chain_packed_ragged.launches
        got = ck.chain_packed_ragged(*args)
        check(ck.chain_packed_ragged.launches == before + 1 or dev.type == "cpu",
              "K13 ragged: not one launch")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ck.chain_packed_ragged_plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs.append(f"{kind} err {err}")

        def run(idxs, kp, kind=kind):
            kp = u32_tensor(kp, dev)
            iv = torch.zeros((kp.shape[3] * 32, 16), dtype=torch.uint8, device=dev)
            iv[:len(idxs)] = torch.from_numpy(ivs[idxs]).to(dev)
            nb = steps[idxs[0]]
            if kind == "ofb":
                return ck.ofb_packed_fused(kp, iv, nb)[:len(idxs)].cpu().numpy()
            x = torch.zeros((iv.shape[0], nb, 16), dtype=torch.uint8, device=dev)
            x[:len(idxs)] = torch.from_numpy(np.stack([data[i] for i in idxs])).to(dev).reshape(
                len(idxs), nb, 16)
            return ck.chain_packed_fused(kind, kp, iv, x)[:len(idxs)].cpu().numpy()

        groups = per_group(keys, steps, run)
        host = got.cpu().numpy()
        for k, i in enumerate(lay.order):
            off = lay.offsets[k]
            check(np.array_equal(host[off:off + 16 * steps[i]], groups[i].reshape(-1)),
                  f"K13 ragged {kind}: message {i} != its group's uniform launch")
        res.record("chain_packed_ragged", err)
        if kind == "cbc":
            errs.append(f"{cuda_ms(lambda: ck.chain_packed_ragged(*args), 10):.4f} ms (plain "
                        f"{start.elapsed_time(end):.1f} ms)")
    return (f"K13 ragged ({len(keys)} messages, {lay.desc.shape[0]} words, keys of 16/24/32 B, "
            f"2..256 blocks, equal to the per-group launches) " + ", ".join(errs))


def carry_bases(c0):
    """Make the first three counter bases carry: bytes 9..15 all 0xFF (the
    window wraps to 0 at step 1, byte 8 untouched), bytes 12..15 0xFF (a
    carry into byte 11 at step 1), and bytes 9..11 0xFF with bytes 12..15
    0xFFFFFFF0 (a carry through bytes 9..11 at step 16)."""
    c0[0, 9:] = 0xFF
    c0[1, 12:] = 0xFF
    c0[2, 9:] = 0xFF
    c0[2, 15] = 0xF0
    return c0


def aead_kernels(dev, rng, gen, res: Results):
    """Phase 8: K11 (CCM and EAX, both directions, AES-128 and AES-256) at
    2048 messages x 256 blocks and K12 (seal and open, AES-128) at 4096 x 256
    against their plain versions, a random key per message, nvalid from 0
    (SIV: 1) to nb, counter bases that carry into byte 9; times AES-128, each
    call with both its launches (K15's keystream pass and K13's MAC).  Then
    the two kernels alone against their own plain versions: K15 with CCM's
    whitener at 4096 x 256, K13's MAC with tail, lastadd and prevadd at 2048
    x 256.  Returns the latency floors (ms) per kind."""
    import torch

    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def lane_keys(b, klen):
        rks = stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                for _ in range(b)])
        return u32_tensor(key_planes_packed(rks), dev)

    def timed(name, kernel, plain, nbytes, gates):
        got = kernel()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        if nbytes is None:
            res.record(name, err)
        else:
            res.record(name, err, cuda_ms(kernel, 10), start.elapsed_time(end), nbytes, gates)
        return err

    floors, line = {}, []
    b, nb = AEAD_SHAPE
    w = b // 32
    blocks = rand_u8(b, nb, 16)
    c0, init, tail, lastadd = carry_bases(rand_u8(b, 16)), rand_u8(b, 16), rand_u8(b, 16), \
        rand_u8(b, 16)
    nv = rng.integers(0, nb + 1, b).astype(np.int32)
    nv[:2] = (0, nb)
    nvalid = torch.from_numpy(nv).to(dev)
    rows = 4 * b * 16 + 4 * b + b * 16  # c0, init, tail, lastadd, nvalid in; the tag out
    for klen in (16, 32):
        kpw = lane_keys(b, klen)
        rounds = kpw.shape[0] - 1
        for kind in ("ccm", "eax"):
            whiten = kind == "ccm"
            for decrypt in (False, True):
                name = f"aead_chain_{kind}{'_open' if decrypt else ''}"
                args = (kind, kpw, c0, init, blocks, nvalid, tail, lastadd, decrypt)
                err = timed(name, lambda: ak.aead_chain_fused(*args),
                            lambda: ak.aead_chain_fused_plain(*args),
                            *((2 * blocks.numel() + rows + kpw.numel() * 4,
                               w * (nb + whiten) * (aes_gates(rounds) + 128)
                               + int(nv.sum()) * (aes_gates(rounds) + 3 * 128) // 32)
                              if klen == 16 else (None, None)))
                if klen == 16:
                    floors[name] = (1e3 * (int(nv.max()) + whiten) * rounds
                                    * CHAIN_ROUND_CYCLES / CLOCK_HZ)
                line.append(f"{name} AES-{8 * klen} err {err}")
    b, nb = SIV_SHAPE
    w = b // 32
    blocks = rand_u8(b, nb, 16)
    init, tail, lastadd, prevadd = (rand_u8(b, 16) for _ in range(4))
    c0 = carry_bases(rand_u8(b, 16))
    nv = rng.integers(1, nb + 1, b).astype(np.int32)
    nv[:2] = (1, nb)
    nvalid = torch.from_numpy(nv).to(dev)
    kpm, kpc = lane_keys(b, 16), lane_keys(b, 16)
    rounds = kpm.shape[0] - 1
    nbytes = 2 * blocks.numel() + 5 * b * 16 + 4 * b + 2 * kpm.numel() * 4
    gates = (w * nb * (aes_gates(rounds) + 128)
             + int(nv.sum()) * (aes_gates(rounds) + 4 * 128) // 32)
    seal = (kpm, kpc, init, blocks, nvalid, tail, lastadd, prevadd)
    err = timed("siv_seal_chain", lambda: ak.siv_seal_chain_fused(*seal),
                lambda: ak.siv_seal_chain_fused_plain(*seal), nbytes - b * 16, gates)
    line.append(f"siv_seal_chain AES-128 err {err}")
    opened = (kpm, kpc, c0, init, blocks, nvalid, tail, lastadd, prevadd)
    err = timed("siv_open_chain", lambda: ak.siv_open_chain_fused(*opened),
                lambda: ak.siv_open_chain_fused_plain(*opened), nbytes, gates)
    line.append(f"siv_open_chain AES-128 err {err}")
    # the two kernels the calls above launch, each against its own plain
    # version: K15 with CCM's whitener, K13's MAC with every last-step
    # constant
    kerr = timed("ctr_packed", lambda: ak.ctr_packed_fused(kpc, c0, blocks, True),
                 lambda: ak.ctr_packed_fused_plain(kpc, c0, blocks, True), None, None)
    mb = AEAD_SHAPE[0]
    mac = (kpm[..., :mb // 32].contiguous(), init[:mb], blocks[:mb], nvalid[:mb], tail[:mb],
           lastadd[:mb], prevadd[:mb])
    merr = timed("cbcmac_packed", lambda: (ck.cbcmac_packed_fused(*mac),),
                 lambda: (ck.cbcmac_packed_fused_plain(*mac),), None, None)
    line.append(f"K15 whitener err {kerr}, K13 MAC with the last-step constants "
                f"at {mb} x {nb} err {merr}")
    floors["siv_seal_chain"] = 1e3 * (int(nv.max()) + 1) * rounds * CHAIN_ROUND_CYCLES / CLOCK_HZ
    floors["siv_open_chain"] = 1e3 * int(nv.max()) * rounds * CHAIN_ROUND_CYCLES / CLOCK_HZ
    # a round trip: open the sealed batch under its own IVs
    ct, iv = ak.siv_seal_chain_fused(*seal)
    pt, s2v = ak.siv_open_chain_fused(kpm, kpc, ak._siv_bases(iv), init, ct, nvalid, tail,
                                      lastadd, prevadd)
    check(torch.equal(pt, blocks) and torch.equal(s2v, iv), "K12 open(seal) round trip")
    torch.cuda.synchronize()
    phase(8, "AEAD chain kernels", f"K11 at {AEAD_SHAPE[0]} x {AEAD_SHAPE[1]} blocks and K12 "
          f"at {b} x {nb}, a key per message, three counter bases carrying into byte 9; "
          f"plain versions timed once; K12 open(seal) round trip exact; " + ", ".join(line)
          + "; latency floors (ms) " + json.dumps(floors))
    return floors


def wheel_kernels(dev, rng, gen, res: Results):
    """Phase 9: K16 (wrap and unwrap, natural and wide map, AES-128 and
    AES-256) at 2048 messages x 64 semiblocks, K14 (CBC, CFB, OFB; AES-256)
    at the chain batches' 4096 x 256, also against K13, and K15 (AES-128,
    counter bases that carry into byte 9) at 4096 x 256, each against its
    plain version, a key per message; times AES-128 (K14 AES-256) and K9 at
    K15's shape.  Returns the latency floors (ms) per kind."""
    import torch

    from micro_aes_tpu_torch.core.bitslice import key_planes_packed, wide_perm
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops import kw_kernels as kk
    from micro_aes_tpu_torch.ops.multikey import ctrw_multikey_rks, mk_window_words
    from micro_aes_tpu_torch.ops.ragged import ragged_layout
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def round_keys(b, klen):
        return stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                 for _ in range(b)])

    def timed(name, kernel, plain, nbytes, gates, want=None):
        """Kernel and plain version once each, compared (or the kernel
        against `want`, the plain output on the same inputs); with nbytes,
        the kernel timed (mean of 10) and the plain version's one call."""
        got = kernel()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if plain is not None:
            want = plain()
        end.record()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if nbytes is None:
            res.record(name, err)
        else:
            res.record(name, err, cuda_ms(kernel, 10), start.elapsed_time(end), nbytes, gates)
        return got, err, want

    floors, line = {}, []
    # K16: wrap, then unwrap the result with three ICVs tampered
    b, n = KW_SHAPE
    w = b // 32
    secrets = rand_u8(b, n, 8)
    for klen in (16, 32):
        rks = round_keys(b, klen)
        rounds = rks.shape[1] - 1
        kpw = u32_tensor(key_planes_packed(rks), dev)
        kpw_w = u32_tensor(key_planes_packed(rks[wide_perm(b)]), dev)
        timing = klen == 16
        for unwrap in (False, True):
            gates = 6 * n * w * (aes_gates(rounds, unwrap) + 32)
            nbytes = b * (2 * n + 1) * 8 + (b * 8 if unwrap else 0) + kpw.numel() * 4
            if unwrap:
                data = wrapped.clone()
                data[:3, 0, 0] ^= 1
            else:
                data = secrets
            suffix = "_unwrap" if unwrap else ""
            got, err, want = timed(f"kw_packed{suffix}", lambda: kk.kw_packed(kpw, data, unwrap),
                                   lambda: kk.kw_packed_plain(kpw, data, unwrap),
                                   *((nbytes, gates) if timing else (None, None)))
            got_w, err_w, _ = timed(f"kw_packed_fused{suffix}",
                                    lambda: kk.kw_packed_fused(kpw_w, data, unwrap),
                                    lambda: kk.kw_packed_fused_plain(kpw_w, data, unwrap),
                                    *((nbytes, gates) if timing else (None, None)))
            check(torch.equal(got, got_w), f"K16{suffix} wide map != natural map")
            if timing:  # the ragged entry, one run of 64 words: the 2048 x 512 B batch's launch
                lay = ragged_layout([n] * b, [rounds] * b, [8 * (n + 1)] * b)
                kp15 = torch.cat([kpw, kpw.new_zeros((15 - kpw.shape[0],) + kpw.shape[1:])])
                rows = data if unwrap else torch.cat([data.new_zeros(b, 1, 8), data], 1)
                flat = rows.reshape(-1).contiguous()
                got_r, err_r, _ = timed(
                    "kw_wheel_ragged", lambda: kk.kw_wheel_ragged(kp15, lay.desc, flat, unwrap),
                    None if unwrap else lambda: kk.kw_wheel_ragged_plain(kp15, lay.desc, flat),
                    *((None, None) if unwrap else (nbytes, gates)), want=want.reshape(-1))
                err_r = max(err_r, max_abs_err(got_r, want.reshape(-1)))
                res.record("kw_wheel_ragged", err_r)
                err = max(err, err_r)
            if unwrap:
                check(torch.equal(got[3:, 1:], secrets[3:]) and bool((got[3:, 0] == 0xA6).all())
                      and not bool((got[:3, 0] == 0xA6).all(dim=1).any()),
                      "K16 unwrap(wrap) round trip and the tampered ICVs")
            else:
                wrapped = got
            if timing:
                floors[f"kw_packed{suffix}"] = floors[f"kw_packed_fused{suffix}"] = \
                    1e3 * 6 * n * rounds * CHAIN_ROUND_CYCLES / CLOCK_HZ
            line.append(f"K16{suffix} AES-{8 * klen} err {max(err, err_w)}")
    line.append(ragged_kw_kernels(dev, rng, res))
    floors["kw_wheel_ragged"] = floors["kw_packed"]
    # K14 at K13's shape, against its plain version and against K13
    b, nb = CHAIN_SHAPE
    w = b // 32
    rks = round_keys(b, 32)
    kpw = u32_tensor(key_planes_packed(rks), dev)
    kpw_w = u32_tensor(key_planes_packed(rks[wide_perm(b)]), dev)
    ivs, blocks = rand_u8(b, 16), rand_u8(b, nb, 16)
    blk = b * nb * 16
    cases = (  # name, wide kernel, plain, K13, bytes, gates
        ("chain_packed_wide", lambda: ck.chain_packed_fused_wide("cbc", kpw_w, ivs, blocks),
         lambda: ck.chain_packed_fused_wide_plain("cbc", kpw_w, ivs, blocks),
         lambda: ck.chain_packed_fused("cbc", kpw, ivs, blocks),
         2 * blk + b * 16 + kpw.numel() * 4, w * nb * (aes_gates(14) + 128)),
        ("chain_packed_wide_cfb", lambda: ck.chain_packed_fused_wide("cfb", kpw_w, ivs, blocks),
         lambda: ck.chain_packed_fused_wide_plain("cfb", kpw_w, ivs, blocks),
         lambda: ck.chain_packed_fused("cfb", kpw, ivs, blocks),
         2 * blk + b * 16 + kpw.numel() * 4, w * nb * (aes_gates(14) + 128)),
        ("ofb_packed_wide", lambda: ck.ofb_packed_fused_wide(kpw_w, ivs, nb),
         lambda: ck.ofb_packed_fused_wide_plain(kpw_w, ivs, nb),
         lambda: ck.ofb_packed_fused(kpw, ivs, nb),
         blk + b * 16 + kpw.numel() * 4, w * nb * aes_gates(14)),
    )
    for name, kernel, plain, k13, nbytes, gates in cases:
        got, err, _ = timed(name, kernel, plain, nbytes, gates)
        check(torch.equal(got, k13()), f"{name} != K13 on the same messages")
        floors[name] = 1e3 * nb * 14 * CHAIN_ROUND_CYCLES / CLOCK_HZ
        line.append(f"{name} AES-256 err {err}")
    # K15 at SIV's shape, and K9 (the JAX package's other SIV keystream
    # kernel) on as many blocks
    b, nb = SIV_SHAPE
    w = b // 32
    rks = round_keys(b, 16)
    kpw = u32_tensor(key_planes_packed(rks), dev)
    c0, blocks = carry_bases(rand_u8(b, 16)), rand_u8(b, nb, 16)
    _, err, _ = timed("ctr_packed", lambda: ak.ctr_packed_fused(kpw, c0, blocks),
                   lambda: ak.ctr_packed_fused_plain(kpw, c0, blocks),
                   2 * blocks.numel() + b * 16 + kpw.numel() * 4,
                   w * nb * (aes_gates(10) + 128))
    line.append(f"ctr_packed AES-128 err {err}")
    line.append(k15_edge_cases(dev, rng, res))
    wm = mk_window_words(nb)
    rk_dev = torch.from_numpy(rks).to(dev)
    words = torch.randint(-2**31, 2**31, (b * wm, 128), dtype=torch.int32, device=dev,
                          generator=gen)
    k9_ms = cuda_ms(lambda: ctrw_multikey_rks(rk_dev, words, words, b), 10)
    torch.cuda.synchronize()
    phase(9, "wheel, wide-chain and CTR kernels",
          f"K16 at {KW_SHAPE[0]} x {KW_SHAPE[1]} semiblocks (wrap, then unwrap with three "
          f"ICVs tampered; the wide map equal to the natural one), K14 at {CHAIN_SHAPE[0]} x "
          f"{CHAIN_SHAPE[1]} (equal to K13), K15 at {b} x {nb} with three counter bases "
          f"carrying into byte 9, a key per message; plain versions timed once; "
          + ", ".join(line) + f"; K9 at {b} x {nb} AES-128 {k9_ms:.4f} ms; latency floors (ms) "
          + json.dumps(floors))
    return floors


def k15_edge_cases(dev, rng, res: Results) -> str:
    """K15 in each thread layout (the entry's pick, then 4, 2 and 1 state
    columns a thread through the C entry, which counts no launch) against
    its plain version at its edges: counter bases whose window wraps at step
    1 (its carry out of byte 9 dropped, byte 8 kept, also under byte 8 =
    0xFF), carries into byte 11 and through bytes 9..11, CCM's whitener, nb
    = 1, nb that ends inside a block's steps, one word (W = 1); keys of
    16/24/32 bytes.  Returns the phase line's part."""
    import torch

    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import _build
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def forced(kpw, c0, blocks, whiten, cols):
        out = torch.empty_like(blocks)
        wh = torch.empty_like(c0) if whiten else None
        err = lib.micro_aes_ctr_packed(kpw.data_ptr(), c0.data_ptr(), blocks.data_ptr(),
                                       out.data_ptr(), None if wh is None else wh.data_ptr(),
                                       kpw.shape[0] - 1, kpw.shape[3], blocks.shape[1], cols,
                                       stream)
        _build.check_launch("ctr_packed_fused", err)
        return (out, wh) if whiten else (out,)

    worst = 0
    for klen in (16, 24, 32):
        for b, nb in ((32, 1), (32, 33), (64, 130), (96, 257)):
            rks = stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                    for _ in range(b)])
            kpw = u32_tensor(key_planes_packed(rks), dev)
            c0 = torch.from_numpy(rng.integers(0, 256, (b, 16), dtype=np.uint8)).to(dev)
            c0[0, 9:] = 0xFF
            c0[1, 8:] = 0xFF
            c0[2, 12:] = 0xFF
            c0[3, 9:] = 0xFF
            c0[3, 15] = 0xF0
            blocks = torch.from_numpy(rng.integers(0, 256, (b, nb, 16), dtype=np.uint8)).to(dev)
            for whiten in (False, True):
                want = ak.ctr_packed_fused_plain(kpw, c0, blocks, whiten)
                want = want if whiten else (want,)
                got = ak.ctr_packed_fused(kpw, c0, blocks, whiten)
                runs = [got if whiten else (got,)] + [forced(kpw, c0, blocks, whiten, cols)
                                                      for cols in (4, 2, 1)]
                for run in runs:
                    err = max(max_abs_err(g, w) for g, w in zip(run, want))
                    res.record("ctr_packed", err)
                    worst = max(worst, err)
    torch.cuda.synchronize()
    return (f"K15 edges (W = 1/2/3, nb = 1/33/130/257, whitened or not, AES-128/192/256, "
            f"4/2/1 columns a thread and the entry's pick) err {worst}")


def ragged_kw_kernels(dev, rng, res: Results) -> str:
    """K16's ragged entry on RAGGED_KW_MIX in one launch each way (wrap, then
    unwrap with three ICVs tampered) against its plain version and against
    K16's uniform entry run per (n, KEK size) group; times the wrap for the
    phase line (the kernels line's time is phase 9's, at the batch's
    shape).  Returns the phase line's part."""
    import torch

    from micro_aes_tpu_torch.ops import kw_kernels as kk
    from micro_aes_tpu_torch.ops.ragged import layout_key_planes, ragged_layout
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    keks, ns = ragged_keys(rng, RAGGED_KW_MIX)
    lay = ragged_layout(ns, [len(k) // 4 + 6 for k in keks], [8 * (n + 1) for n in ns])
    kpw = layout_key_planes(keks, lay, dev)
    rows = [rng.integers(0, 256, 8 * (n + 1), dtype=np.uint8) for n in ns]
    for r in rows:
        r[:8] = 0  # the unused first semiblock of a wrap row
    errs, wrapped = [], None
    for unwrap in (False, True):
        if unwrap:
            host = wrapped.copy()
            for k in range(3):  # three tampered ICVs
                host[lay.offsets[k]] ^= 1
            data = torch.from_numpy(host).to(dev)
        else:
            data = torch.from_numpy(np.concatenate([rows[i] for i in lay.order])).to(dev)
        before = kk.kw_wheel_ragged.launches
        got = kk.kw_wheel_ragged(kpw, lay.desc, data, unwrap)
        check(kk.kw_wheel_ragged.launches == before + 1 or dev.type == "cpu",
              "K16 ragged: not one launch")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = kk.kw_wheel_ragged_plain(kpw, lay.desc, data, unwrap)
        end.record()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs.append(f"{'unwrap' if unwrap else 'wrap'} err {err}")
        src = data.cpu().numpy()

        def run(idxs, kp):
            kp = u32_tensor(kp, dev)
            n = ns[idxs[0]]
            x = np.zeros((kp.shape[3] * 32, n + 1, 8), np.uint8)
            for j, i in enumerate(idxs):
                off = lay.offsets[int(np.flatnonzero(lay.order == i)[0])]
                x[j] = src[off:off + 8 * (n + 1)].reshape(n + 1, 8)
            x = torch.from_numpy(x if unwrap else x[:, 1:].copy()).to(dev)
            return kk.kw_packed(kp, x, unwrap)[:len(idxs)].cpu().numpy()

        groups = per_group(keks, ns, run)
        host = got.cpu().numpy()
        for k, i in enumerate(lay.order):
            off = lay.offsets[k]
            check(np.array_equal(host[off:off + 8 * (ns[i] + 1)], groups[i].reshape(-1)),
                  f"K16 ragged: message {i} != its group's uniform launch")
        res.record("kw_wheel_ragged", err)
        if unwrap:
            icv_ok = [bool((host[off:off + 8] == 0xA6).all()) for off in lay.offsets]
            check(icv_ok == [k >= 3 for k in range(len(icv_ok))], "K16 ragged: tampered ICVs")
        else:
            wrapped = host
            errs.append(f"{cuda_ms(lambda: kk.kw_wheel_ragged(kpw, lay.desc, data), 10):.4f} ms "
                        f"(plain {start.elapsed_time(end):.1f} ms)")
    return (f"K16 ragged ({len(keks)} messages, {lay.desc.shape[0]} words, KEKs of 16/24/32 B, "
            f"n 2..64, three ICVs tampered, equal to the per-group launches) " + ", ".join(errs))


def anchors(dev, rng):
    """Phase 10: published answers through every entry point."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.core.bitslice import (
        blocks_to_words,
        planes_to_words,
        words_to_blocks,
        words_to_planes,
    )
    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.testing import kat

    for key, pt, ct in kat.FIPS_VECTORS:
        kp, _ = seal.gcm_key_setup(key, device=dev)
        blocks = torch.zeros((32, 16), dtype=torch.uint8, device=dev)
        blocks[0] = torch.frombuffer(bytearray(pt), dtype=torch.uint8)
        planes = words_to_planes(blocks_to_words(blocks).contiguous())
        enc = cipher_planes(kp, planes)
        got = bytes(words_to_blocks(planes_to_words(enc))[0].cpu().numpy())
        back = words_to_blocks(planes_to_words(cipher_planes(kp, enc, True)))[0]
        check(got == ct and bytes(back.cpu().numpy()) == pt,
              f"FIPS-197 AES-{8 * len(key)} through K2")
        check(aes.aes_cipher(key, "E", pt) == ct, "FIPS-197 through the byte oracle")
    vectors = [(name, key, iv, b"", pt, ct, tag) for name, key, iv, pt, ct, tag
               in kat.GCM_SPEC_VECTORS] + list(kat.GCM_SPEC_AEAD_VECTORS)
    for name, key, iv, aad, pt, ct, tag in vectors:
        check(aes.gcm_encrypt(key, iv, aad, pt, device=dev) == ct + tag, f"GCM {name} gcm_encrypt")
        check(aes.gcm_decrypt(key, iv, aad, ct + tag, device=dev) == pt, f"GCM {name} gcm_decrypt")
        if len(iv) == 12 and len(pt) % 16 == 0:
            check(aes.gcm_seal(key, iv, pt, aad, device=dev) == ct + tag, f"GCM {name} seal")
            check(aes.gcm_open(key, iv, ct + tag, aad, device=dev) == pt, f"GCM {name} open")
    # all seven as one (ragged: mixed key sizes, 8/60-byte IVs) batch, then
    # the AES-128 whole-block ones as a fast-path batch
    fast = [v for v in vectors if len(v[1]) == 16 and len(v[2]) == 12 and len(v[4]) % 16 == 0]
    check(len(fast) >= 2, "no fast-path anchor batch")
    for batch in (vectors, fast):
        cols = list(zip(*batch))
        got = aes.gcm_seal_batch(cols[1], cols[2], cols[3], cols[4], device=dev)
        check(got == [ct + tag for ct, tag in zip(cols[5], cols[6])], "GCM vectors gcm_seal_batch")
        check(aes.gcm_open_batch(cols[1], cols[2], cols[3], got, device=dev) == list(cols[4]),
              "GCM vectors gcm_open_batch")
    n_rand = 0
    for nb in (1, 33, 257):
        for alen in (0, 20):
            key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
            pt = rng.integers(0, 256, 16 * nb, dtype=np.uint8).tobytes()
            aad = rng.integers(0, 256, alen, dtype=np.uint8).tobytes()
            check(seal.gcm_seal(key, nonce, pt, aad, device=dev)
                  == oracle_gcm(key, nonce, pt, aad), f"oracle {nb} blocks aad {alen}")
            n_rand += 1
    for name, key, nonce, aad, pt, blob in kat.GCM_SIV_VECTORS:
        check(aes.gcm_siv_encrypt(key, nonce, aad, pt, device=dev) == blob,
              f"GCM-SIV {name} gcm_siv_encrypt")
        check(aes.gcm_siv_decrypt(key, nonce, aad, blob, device=dev) == pt,
              f"GCM-SIV {name} gcm_siv_decrypt")
    for name, keys, tweak, pt, ct in kat.XTS_VECTORS:
        check(aes.xts_encrypt(keys, tweak, pt, device=dev) == ct, f"XTS {name} xts_encrypt")
        check(aes.xts_decrypt(keys, tweak, ct, device=dev) == pt, f"XTS {name} xts_decrypt")
    sector = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
    lba = 0x1234_5678_9ABC
    sealed = aes.xts_seal_sectors(keys, [lba], sector, 512, device=dev)
    check(sealed == aes.xts_encrypt(keys, None, sector, sector_id=lba, device=dev),
          "XTS256 key: xts_seal_sectors != xts_encrypt")
    check(aes.xts_open_sectors(keys, [lba], sealed, 512, device=dev) == sector,
          "XTS256 key: xts_open_sectors round trip")
    for name, key, nonce, aad, pt, blob in kat.OCB_VECTORS:
        check(aes.ocb_encrypt(key, nonce, aad, pt, device=dev) == blob, f"OCB {name} ocb_encrypt")
        check(aes.ocb_decrypt(key, nonce, aad, blob, device=dev) == pt, f"OCB {name} ocb_decrypt")
        check(aes.ocb_seal(key, nonce, aad, pt, device=dev) == blob, f"OCB {name} ocb_seal")
        check(aes.ocb_open(key, nonce, aad, blob, device=dev) == pt, f"OCB {name} ocb_open")
    key, iv, aad, pt = kat.MAIN_KEY, kat.MAIN_IV, kat.MAIN_AAD, kat.MAIN_PLAINTEXT
    check(aes.ccm_encrypt(key[:16], iv[:11], aad, pt, device=dev) == kat.CCM128, "main.c CCM128")
    check(aes.ccm_decrypt(key[:16], iv[:11], aad, kat.CCM128, device=dev) == pt, "CCM128 decrypt")
    check(aes.eax_encrypt(key[:16], iv, aad, pt, device=dev) == kat.EAX128, "main.c EAX128")
    check(aes.eax_decrypt(key[:16], iv, aad, kat.EAX128, device=dev) == pt, "EAX128 decrypt")
    check(aes.eaxp_encrypt(key[:16], aad, pt, device=dev) == kat.EAXP128, "main.c EAXP128")
    iv128, ct128 = aes.siv_encrypt(key, aad, pt, device=dev)
    check(iv128 + ct128 == kat.SIV128, "main.c SIV128")
    check(aes.siv_decrypt(key, iv128, aad, ct128, device=dev) == pt, "SIV128 decrypt")
    keys, aad5297, pt5297, blob = kat.SIV_RFC5297
    check(b"".join(aes.siv_encrypt(keys, aad5297, pt5297, device=dev)) == blob, "RFC 5297 A.1")
    for name, key, nd, pt, blob in kat.EAXP_VECTORS:
        check(aes.eaxp_encrypt(key, nd, pt, device=dev) == blob, f"EAX' {name}")
        check(aes.eaxp_decrypt(key, nd, blob, device=dev) == pt, f"EAX' {name} decrypt")
    phase(10, "anchors", f"FIPS-197 x3 through K2, McGrew-Viega GCM x{len(vectors)} through "
          f"gcm_encrypt/gcm_decrypt (x{len(kat.GCM_SPEC_VECTORS)} through gcm_seal/gcm_open), "
          f"as a ragged batch and a fast-path batch of {len(fast)}, oracle x{n_rand} "
          f"(1/33/257 blocks, with and without AAD), GCM-SIV x{len(kat.GCM_SIV_VECTORS)} "
          f"(main.c, RFC 8452) through gcm_siv_encrypt/gcm_siv_decrypt, XTS "
          f"x{len(kat.XTS_VECTORS)} (main.c) through xts_encrypt/xts_decrypt and a 512-byte "
          f"sector of the XTS256 key through xts_seal_sectors/xts_open_sectors, OCB "
          f"x{len(kat.OCB_VECTORS)} (main.c, RFC 7253) through ocb_encrypt/ocb_decrypt and "
          f"ocb_seal/ocb_open, main.c CCM128/EAX128/EAXP128/SIV128, RFC 5297 A.1 and EAX' "
          f"x{len(kat.EAXP_VECTORS)} (IEEE 1703) per message: all match")


def single_key_requests(dev, rng):
    """Phase 11: 16 MiB requests; returns the K1-K3 launch counts."""
    import torch

    from micro_aes_tpu_torch import AuthenticationError
    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.ops.seal_kernels import ctr_fused, seal_fused

    n = MIB16_BLOCKS

    def req(klen, key=None):
        return (key or rng.integers(0, 256, klen, dtype=np.uint8).tobytes(),
                rng.integers(0, 256, 12, dtype=np.uint8).tobytes(),
                rng.integers(0, 256, 16 * n, dtype=np.uint8).tobytes(),
                rng.integers(0, 256, AAD_BYTES, dtype=np.uint8).tobytes())

    # a user seals and opens large messages under one key: three AES-256
    # requests share a key (the first pays the per-key setup), then one
    # request each for AES-128 and AES-192
    key256 = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    requests = [req(32, key256), req(32, key256), req(32, key256), req(16), req(24)]
    ctr_req = req(32)
    v2_key, v2_nonce, v2_pt, _ = req(32)
    for fn in (seal_fused, cipher_planes, ctr_fused):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sealed, t_seal, t_open = [], [], []
    for key, nonce, pt, aad in requests:
        t1 = time.perf_counter()
        blob = seal.gcm_seal(key, nonce, pt, aad, device=dev)
        t2 = time.perf_counter()
        opened = seal.gcm_open(key, nonce, blob, aad, device=dev)
        t_seal.append(t2 - t1)
        t_open.append(time.perf_counter() - t2)
        check(opened == pt, f"open(seal) round trip AES-{8 * len(key)}")
        sealed.append(blob)
    key, nonce, _, aad = requests[0]
    bad = sealed[0][:-1] + bytes([sealed[0][-1] ^ 0x01])
    released = None
    try:
        released = seal.gcm_open(key, nonce, bad, aad, device=dev)
    except AuthenticationError:
        pass
    else:
        raise RuntimeError("a tampered tag was accepted")
    check(released is None, "plaintext released for a tampered tag")
    ck, cn, cpt, _ = ctr_req
    cct = seal.ctr_bulk(ck, cn, cpt, device=dev)
    check(seal.ctr_bulk(ck, cn, cct, device=dev) == cpt, "ctr_bulk round trip")
    kp, tables = seal.gcm_key_setup(v2_key, device=dev)
    j0 = seal._j0_block(v2_nonce, dev)
    v2_blocks = torch.frombuffer(bytearray(v2_pt), dtype=torch.uint8).reshape(n, 16).to(dev)
    v2_ct, v2_tag = seal.gcm_seal_kernel(kp, tables, j0, v2_blocks)
    v2_blob = bytes(v2_ct.cpu().numpy().reshape(-1)) + bytes(v2_tag.cpu().numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"seal_fused": seal_fused.launches, "cipher_planes": cipher_planes.launches,
                "ctr_fused": ctr_fused.launches}

    # references: the same pipeline with the plain versions, on the card
    with plain_kernels():
        for (key, nonce, pt, aad), blob in zip(requests, sealed):
            check(seal.gcm_seal(key, nonce, pt, aad, device=dev) == blob,
                  f"16 MiB AES-{8 * len(key)} seal != plain pipeline")
        check(seal.ctr_bulk(ck, cn, cpt, device=dev) == cct, "ctr_bulk != plain pipeline")
        ref_ct, ref_tag = seal.gcm_seal_kernel(kp, tables, j0, v2_blocks)
    check(v2_blob == bytes(ref_ct.cpu().numpy().reshape(-1)) + bytes(ref_tag.cpu().numpy()),
          "v2 gcm_seal_kernel != plain pipeline")
    check(v2_blob == seal.gcm_seal(v2_key, v2_nonce, v2_pt, device=dev),
          "v2 gcm_seal_kernel != fused gcm_seal")
    phase(11, "requests", f"{len(requests)} seal+open round trips of {16 * n / 2**20:g} MiB "
          f"(3x AES-256 under one key, AES-128, AES-192; {AAD_BYTES} B AAD), tamper rejected, "
          f"ctr_bulk round trip, v2 seal: all equal the plain pipeline; {wall:.3f} s wall; "
          f"host-clock seconds per request, seal {', '.join(f'{x:.4f}' for x in t_seal)}; "
          f"open {', '.join(f'{x:.4f}' for x in t_open)}")
    return launches


def batch_requests(dev, rng):
    """Phase 12: multi-key batch requests; returns the K9 (ragged entry) and
    K10 launch counts and the host-clock seconds per batch."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.ops.chain import gcm_chain_fused_raw
    from micro_aes_tpu_torch.ops.multikey import cipher_blocks_ragged

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def split(blob, n, size):
        return [blob[i * size:(i + 1) * size] for i in range(n)]

    batches = []
    for b, size in BATCH_SHAPES:
        batches.append((f"{b}x{size >> 10}KB", [rand(16) for _ in range(b)],
                        [rand(12) for _ in range(b)], [rand(TLS_AAD_BYTES) for _ in range(b)],
                        split(rand(b * size), b, size)))
    # TLS-record shaped: mixed key sizes, one 8- and one 60-byte nonce,
    # records of 0..2 KiB that are not whole blocks
    nrec = 256
    lens = [int(x) | 1 for x in rng.integers(0, 2048, nrec)]
    lens[0] = 0
    nonce_lens = [12] * nrec
    nonce_lens[1], nonce_lens[2] = 8, 60
    ragged = ("ragged TLS", [rand((16, 24, 32)[i % 3]) for i in range(nrec)],
              [rand(n) for n in nonce_lens], [rand(TLS_AAD_BYTES) for _ in range(nrec)],
              [rand(n) for n in lens])

    cipher_blocks_ragged.launches = gcm_chain_fused_raw.launches = 0
    torch.cuda.synchronize()
    times, sealed = {}, {}
    for name, keys, nonces, aads, pts in batches + [ragged]:
        t = []
        for _ in range(2):  # a new key set (setup included), then warm
            t0 = time.perf_counter()
            blobs = aes.gcm_seal_batch(keys, nonces, aads, pts, device=dev)
            t.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        opened = aes.gcm_open_batch(keys, nonces, aads, blobs, device=dev)
        t.append(time.perf_counter() - t0)
        check(opened == pts, f"{name}: open(seal) round trip")
        times[name] = {"seal_cold_s": t[0], "seal_s": t[1], "open_s": t[2]}
        sealed[name] = blobs
    name, keys, nonces, aads, pts = batches[0]
    bad = list(sealed[name])
    bad[5] = bad[5][:-1] + bytes([bad[5][-1] ^ 0x01])
    back = aes.gcm_open_batch(keys, nonces, aads, bad, device=dev)
    check(back[5] is None and back[:5] + back[6:] == pts[:5] + pts[6:],
          f"{name}: a tampered tag must fail alone")
    torch.cuda.synchronize()
    launches = {"multikey_ragged": cipher_blocks_ragged.launches,
                "gcm_chain": gcm_chain_fused_raw.launches}
    # the ragged batch takes the ragged engine, one K9 launch per call
    # (seal twice, open once) whatever its key sizes; the others K10
    check(launches["multikey_ragged"] == 3 or dev.type == "cpu",
          f"K9 launches {launches['multikey_ragged']}, expected 3 (one per ragged call)")

    # references: the same calls with the plain versions on the card, and
    # samples against the per-message API and the single-key bulk seal
    with plain_kernels():
        for name, keys, nonces, aads, pts in batches + [ragged]:
            check(aes.gcm_seal_batch(keys, nonces, aads, pts, device=dev) == sealed[name],
                  f"{name}: seal != plain pipeline")
            check(aes.gcm_open_batch(keys, nonces, aads, sealed[name], device=dev) == pts,
                  f"{name}: open != plain pipeline")
    n_sample = 0
    for name, keys, nonces, aads, pts in batches + [ragged]:
        for i in (0, len(keys) - 1):
            blob = aes.gcm_encrypt(keys[i], nonces[i], aads[i], pts[i], device=dev)
            check(blob == sealed[name][i], f"{name}[{i}] != gcm_encrypt")
            if name != ragged[0]:
                check(aes.gcm_seal(keys[i], nonces[i], pts[i], aads[i], device=dev) == blob,
                      f"{name}[{i}] != gcm_seal")
            n_sample += 1
    phase(12, "batch requests", f"{', '.join(n for n, *_ in batches)} (AES-128, {TLS_AAD_BYTES} B "
          f"AAD) and a ragged TLS-shaped batch of {nrec}: round trips, one tamper rejected "
          f"alone, all equal the plain pipeline, {n_sample} samples equal gcm_encrypt (and "
          f"gcm_seal); host-clock seconds per batch {json.dumps(times)}")
    return launches, times


def siv_requests(dev, rng):
    """Phase 13: 16 MiB GCM-SIV requests; returns the K4/K5/K5-open launch
    counts and the host-clock seconds per request."""
    import torch

    from micro_aes_tpu_torch import AuthenticationError, gcm_siv_encrypt
    from micro_aes_tpu_torch.modes import siv_seal
    from micro_aes_tpu_torch.ops.siv_kernels import ghash1_fused, siv_ctrw_fused, siv_open_fused

    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    n = MIB16_BLOCKS
    key256, nonce_a = rand(32), rand(12)
    # GCM-SIV derives its keys per (key, nonce): a new nonce pays the
    # per-(key, nonce) setup, the same pair again finds it cached (warm)
    requests = [("AES-256 new nonce", key256, nonce_a, rand(16 * n)),
                ("AES-256 same nonce (warm)", key256, nonce_a, rand(16 * n)),
                ("AES-256 new nonce", key256, rand(12), rand(16 * n)),
                ("AES-128 new nonce", rand(16), rand(12), rand(16 * n))]
    for fn in (ghash1_fused, siv_ctrw_fused, siv_open_fused):
        fn.launches = 0
    torch.cuda.synchronize()
    times, sealed = [], []
    for label, key, nonce, pt in requests:
        t0 = time.perf_counter()
        blob = siv_seal.gcm_siv_seal(key, nonce, pt, device=dev)
        t1 = time.perf_counter()
        check(siv_seal.gcm_siv_open(key, nonce, blob, device=dev) == pt, f"GCM-SIV {label} round trip")
        times.append({"request": label, "seal_s": t1 - t0, "open_s": time.perf_counter() - t1})
        sealed.append(blob)
    _, key, nonce, pt = requests[0]
    bad = sealed[0][:-1] + bytes([sealed[0][-1] ^ 0x01])
    released = None
    try:
        released = siv_seal.gcm_siv_open(key, nonce, bad, device=dev)
    except AuthenticationError:
        pass
    else:
        raise RuntimeError("GCM-SIV: a tampered tag was accepted")
    check(released is None, "GCM-SIV: plaintext released for a tampered tag")
    torch.cuda.synchronize()
    launches = {"ghash1_fused": ghash1_fused.launches, "siv_ctrw_fused": siv_ctrw_fused.launches,
                "siv_open_fused": siv_open_fused.launches}

    # references: the same pipeline with the plain versions on the card,
    # and samples against the per-message API
    with plain_kernels():
        for (label, key, nonce, pt), blob in zip(requests, sealed):
            check(siv_seal.gcm_siv_seal(key, nonce, pt, device=dev) == blob,
                  f"16 MiB GCM-SIV {label} seal != plain pipeline")
        _, key, nonce, pt = requests[0]
        check(siv_seal.gcm_siv_open(key, nonce, sealed[0], device=dev) == pt,
              "16 MiB GCM-SIV open != plain pipeline")
    sizes = ((4 << 10, 32), (64 << 10, 16))
    for nbytes, klen in sizes:
        key, nonce, pt = rand(klen), rand(12), rand(nbytes)
        check(siv_seal.gcm_siv_seal(key, nonce, pt, device=dev)
              == gcm_siv_encrypt(key, nonce, b"", pt, device=dev),
              f"GCM-SIV {nbytes} B AES-{8 * klen}: gcm_siv_seal != gcm_siv_encrypt")
    phase(13, "GCM-SIV requests", f"{len(requests)} seal+open round trips of {16 * n / 2**20:g} "
          f"MiB, tamper rejected, all equal the plain pipeline; gcm_siv_seal equals "
          f"gcm_siv_encrypt at {', '.join(f'{b >> 10} KiB AES-{8 * k}' for b, k in sizes)}; "
          f"host-clock seconds per request {json.dumps(times)}")
    return launches, times


def xts_ocb_requests(dev, rng):
    """Phase 14: XTS disk-sector and OCB requests; returns the K6/K7/K8/K2
    launch counts and the host-clock seconds per request."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch import AuthenticationError
    from micro_aes_tpu_torch.modes import ocb_bulk, xts_bulk
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.ops.xex_kernels import ctrw_fused, ocb_fused, xex_fused

    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    n_bytes = 16 * MIB16_BLOCKS
    # AES-256-XTS over a disk: integer LBAs, little-endian as dm-crypt's
    # plain64; 4 KiB and 512 B sectors take K6, 4,160-byte sectors (4096 +
    # 64 B LBA formats) the K2 fallback
    disks = []
    for sector, nbytes in ((4096, n_bytes), (512, n_bytes), (4160, (1 << 20) // 4160 * 4160)):
        s = nbytes // sector
        first = int(rng.integers(0, 2**40))
        disks.append((f"{s}x{sector}B", sector, list(range(first, first + s)), rand(nbytes)))
    ocb_pt = rand(n_bytes + 5)  # a ragged tail
    ocb_nonce, ocb_aad = rand(12), rand(AAD_BYTES)

    for fn in (xex_fused, ocb_fused, ctrw_fused, cipher_planes):
        fn.launches = 0
    torch.cuda.synchronize()
    times, sealed, n_xts = {}, {}, 0
    for name, sector, lbas, data in disks:
        keys = rand(64)
        t = []
        for _ in range(2):  # a new key pair (its setup included), then warm
            t0 = time.perf_counter()
            out = aes.xts_seal_sectors(keys, lbas, data, sector, device=dev)
            t.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = aes.xts_open_sectors(keys, lbas, out, sector, device=dev)
        t.append(time.perf_counter() - t0)
        check(back == data, f"XTS {name}: open(seal) round trip")
        times[f"XTS {name}"] = {"seal_new_key_s": t[0], "seal_s": t[1], "open_s": t[2]}
        sealed[name] = (keys, out)
        n_xts += 3
    key = rand(16)
    t = []
    for _ in range(2):
        t0 = time.perf_counter()
        blob = aes.ocb_seal(key, ocb_nonce, ocb_aad, ocb_pt, device=dev)
        t.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    check(aes.ocb_open(key, ocb_nonce, ocb_aad, blob, device=dev) == ocb_pt,
          "OCB: open(seal) round trip")
    t.append(time.perf_counter() - t0)
    times["OCB 16 MiB + 5 B"] = {"seal_new_key_s": t[0], "seal_s": t[1], "open_s": t[2]}
    bad = blob[:-1] + bytes([blob[-1] ^ 0x01])
    released = None
    try:
        released = aes.ocb_open(key, ocb_nonce, ocb_aad, bad, device=dev)
    except AuthenticationError:
        pass
    else:
        raise RuntimeError("OCB: a tampered tag was accepted")
    check(released is None, "OCB: plaintext released for a tampered tag")
    torch.cuda.synchronize()
    launches = {"xex_fused": xex_fused.launches, "ocb_fused": ocb_fused.launches,
                "ctrw_fused": ctrw_fused.launches, "cipher_planes": cipher_planes.launches}
    n_k6 = sum(3 for _, sector, _, _ in disks if sector % 512 == 0)
    expect = {"xex_fused": n_k6, "ocb_fused": 4, "ctrw_fused": 0,
              "cipher_planes": n_xts + (n_xts - n_k6)}
    check(launches == expect or dev.type == "cpu",  # a CPU rehearsal launches nothing
          f"XTS/OCB launches {launches}, expected {expect}")

    # references: the same pipeline with the plain versions on the card, and
    # samples against the per-message API
    with plain_kernels():
        for name, sector, lbas, data in disks:
            keys, out = sealed[name]
            check(xts_bulk.xts_seal_sectors(keys, lbas, data, sector, device=dev) == out,
                  f"XTS {name}: seal != plain pipeline")
        check(ocb_bulk.ocb_seal(key, ocb_nonce, ocb_aad, ocb_pt, device=dev) == blob,
              "OCB: seal != plain pipeline")
        check(ocb_bulk.ocb_open(key, ocb_nonce, ocb_aad, blob, device=dev) == ocb_pt,
              "OCB: open != plain pipeline")
    n_sample = 0
    for name, sector, lbas, data in disks:
        keys, out = sealed[name]
        for i in (0, len(lbas) // 2, len(lbas) - 1):
            want = aes.xts_encrypt(keys, None, data[i * sector:(i + 1) * sector],
                                   sector_id=lbas[i], device=dev)
            check(out[i * sector:(i + 1) * sector] == want, f"XTS {name}[{i}] != xts_encrypt")
            n_sample += 1
    check(aes.ocb_encrypt(key, ocb_nonce, ocb_aad, ocb_pt, device=dev) == blob,
          "OCB 16 MiB + 5 B: ocb_seal != ocb_encrypt")
    phase(14, "XTS and OCB requests", f"AES-256-XTS {', '.join(d[0] for d in disks)} and "
          f"AES-128-OCB of 16 MiB + 5 B ({AAD_BYTES} B AAD): round trips, tamper rejected, all "
          f"equal the plain pipeline, {n_sample} sectors equal xts_encrypt, the OCB seal "
          f"equals ocb_encrypt; launches {json.dumps(launches)}; host-clock seconds per "
          f"request {json.dumps(times)}")
    return launches, times


def chain_requests(dev, rng):
    """Phase 15: serial-chain requests: the chain batches and CMAC at 4096 x
    4 KiB, a ragged batch of 256 messages, and the per-message modes (the
    main.c answers and samples of the batches); returns the K13 and K9
    (ragged entry) launch counts and the host-clock seconds per request."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.modes import chain_bulk as cb
    from micro_aes_tpu_torch.modes.common import PAD_ISO7816, PAD_PKCS7, PAD_ZERO
    from micro_aes_tpu_torch.ops.chain_kernels import (
        cbcmac_packed_fused,
        chain_packed_fused,
        chain_packed_ragged,
        ofb_packed_fused,
    )
    from micro_aes_tpu_torch.ops.multikey import cipher_blocks_ragged
    from micro_aes_tpu_torch.testing import kat

    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    b, nb = CHAIN_SHAPE
    size = 16 * nb
    blob = rand(b * size)
    pts = [blob[i * size:(i + 1) * size] for i in range(b)]
    keys256, keys128, ivs = [rand(32) for _ in range(b)], [rand(16) for _ in range(b)], \
        [rand(16) for _ in range(b)]
    # ragged: keys of 16/24/32 bytes in turn, 0..4 KiB, never whole blocks
    nrag = 256
    rlens = [int(x) | 1 for x in rng.integers(0, 4096, nrag)]
    rlens[0] = 0
    rkeys = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    rivs, rpts = [rand(16) for _ in range(nrag)], [rand(n) for n in rlens]
    cts_idx = [i for i, n in enumerate(rlens) if n >= 16]  # CTS needs a whole block
    ck, civ, cpt = ([v[i] for i in cts_idx] for v in (rkeys, rivs, rpts))
    nonces = [iv[:12] for iv in rivs]
    pads = (PAD_ZERO, PAD_PKCS7, PAD_ISO7816)

    k13 = (chain_packed_ragged, chain_packed_fused, ofb_packed_fused, cbcmac_packed_fused)
    for fn in k13 + (cipher_blocks_ragged,):
        fn.launches = 0
    torch.cuda.synchronize()
    times, out = {}, {}

    def req(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        times[name] = time.perf_counter() - t0
        return out[name]

    for tag in ("new key set", "warm"):
        req(f"cbc enc {tag}", lambda: cb.cbc_encrypt_batch(keys256, ivs, pts, device=dev))
        req(f"cfb enc {tag}", lambda: cb.cfb_encrypt_batch(keys256, ivs, pts, device=dev))
        req(f"ofb {tag}", lambda: cb.ofb_xcrypt_batch(keys256, ivs, pts, device=dev))
        req(f"cmac {tag}", lambda: bulk.cmac_batch(keys128, pts, device=dev))
    check(req("cbc dec", lambda: cb.cbc_decrypt_batch(keys256, ivs, out["cbc enc warm"],
                                                      device=dev)) == pts, "CBC batch round trip")
    check(req("cfb dec", lambda: cb.cfb_decrypt_batch(keys256, ivs, out["cfb enc warm"],
                                                      device=dev)) == pts, "CFB batch round trip")
    check(cb.ofb_xcrypt_batch(keys256, ivs, out["ofb warm"], device=dev) == pts, "OFB round trip")
    for tag in ("new key set", "warm"):
        check(out[f"cbc enc {tag}"] == out["cbc enc warm"] and out[f"cmac {tag}"] == out["cmac warm"],
              "a warm batch differs from the new one")
    ragged = {
        "ragged cbc-cts": lambda: cb.cbc_encrypt_batch(ck, civ, cpt, device=dev),
        **{f"ragged cbc pad{p}": (lambda p=p: cb.cbc_encrypt_batch(rkeys, rivs, rpts, cts=False,
                                                                     padding=p, device=dev))
           for p in pads},
        "ragged cfb": lambda: cb.cfb_encrypt_batch(rkeys, rivs, rpts, device=dev),
        "ragged ofb": lambda: cb.ofb_xcrypt_batch(rkeys, rivs, rpts, device=dev),
        "ragged ecb": lambda: cb.ecb_encrypt_batch(rkeys, rpts, PAD_PKCS7, device=dev),
        "ragged ctr": lambda: cb.ctr_xcrypt_batch(rkeys, nonces, rpts, device=dev),
        "ragged cmac": lambda: bulk.cmac_batch(rkeys, rpts, device=dev),
    }
    for name, fn in ragged.items():
        req(name, fn)
    check(cb.cbc_decrypt_batch(ck, civ, out["ragged cbc-cts"], device=dev) == cpt,
          "ragged CBC-CTS round trip")
    check(cb.cfb_decrypt_batch(rkeys, rivs, out["ragged cfb"], device=dev) == rpts,
          "ragged CFB round trip")
    check([d[:n] for d, n in zip(cb.ecb_decrypt_batch(rkeys, out["ragged ecb"], device=dev),
                                 rlens)] == rpts, "ragged ECB round trip")
    check(cb.ctr_xcrypt_batch(rkeys, nonces, out["ragged ctr"], device=dev) == rpts,
          "ragged CTR round trip")
    # per message on the card: the main.c answers, then samples of the batches
    key, iv, pt = kat.MAIN_KEY[:16], kat.MAIN_IV, kat.MAIN_PLAINTEXT
    answers = (
        ("ECB128", aes.ecb_encrypt(key, pt, device=dev), kat.ECB128),
        ("ECB192", aes.ecb_encrypt(kat.MAIN_KEY[:24], pt, PAD_PKCS7, device=dev), kat.ECB192),
        ("CBC128_CTS", aes.cbc_encrypt(key, iv, pt, device=dev), kat.CBC128_CTS),
        ("CBC128_PAD0", aes.cbc_encrypt(key, iv, pt, cts=False, device=dev), kat.CBC128_PAD0),
        ("CFB128", aes.cfb_encrypt(key, iv, pt, device=dev), kat.CFB128),
        ("OFB128", aes.ofb_encrypt(key, iv, pt, device=dev), kat.OFB128),
        ("CTR128", aes.ctr_encrypt(key, iv, pt, device=dev), kat.CTR128),
        ("CMAC128", aes.cmac(key, pt, device=dev), kat.CMAC128),
    )
    for name, got, want in answers:
        check(got == want, f"main.c {name} on the card")
    check(aes.cbc_decrypt(key, iv, kat.CBC128_CTS, device=dev) == pt, "CBC128_CTS decrypt")
    check(aes.cfb_decrypt(key, iv, kat.CFB128, device=dev) == pt, "CFB128 decrypt")
    n_sample = 0
    for i in (0, b - 1):
        check(aes.cbc_encrypt(keys256[i], ivs[i], pts[i], device=dev) == out["cbc enc warm"][i]
              and aes.cfb_encrypt(keys256[i], ivs[i], pts[i], device=dev) == out["cfb enc warm"][i]
              and aes.ofb_encrypt(keys256[i], ivs[i], pts[i], device=dev) == out["ofb warm"][i]
              and aes.cmac(keys128[i], pts[i], device=dev) == out["cmac warm"][i],
              f"message {i}: per-message mode != batch")
        n_sample += 1
    torch.cuda.synchronize()
    launches = {"chain_packed_ragged": chain_packed_ragged.launches,
                "chain_packed": chain_packed_fused.launches,
                "ofb_packed": ofb_packed_fused.launches,
                "cbcmac_packed": cbcmac_packed_fused.launches,
                "multikey_ragged": cipher_blocks_ragged.launches}
    expect = {
        # one per CBC/CFB/OFB batch call: 2 x 3 at 4096 x 4 KiB, the OFB round
        # trip, the ragged CBC-CTS, three paddings, CFB and OFB
        "chain_packed_ragged": 6 + 1 + 1 + len(pads) + 2,
        "chain_packed": 3 + 2 * n_sample,  # per message: CTS, PAD0, CFB; samples
        "ofb_packed": 1 + n_sample,
        "cbcmac_packed": 2 + len({len(k) for k in rkeys}) + 1 + n_sample,
        # one per parallel-direction batch call, whatever its lengths and key
        # sizes, and a second for a CBC-CTS decrypt's spliced Y blocks (CS3
        # steals in whole-block messages too): the 4096 x 4 KiB CBC-CTS (2)
        # and CFB (1) decrypts, the ragged ECB and CTR and their round trips
        # (4), the ragged CFB (1) and CBC-CTS (2) decrypts
        "multikey_ragged": 2 + 1 + 4 + 1 + 2,
    }
    check(all(launches[k] == v for k, v in expect.items()) or dev.type == "cpu",
          f"K13/K9 launches {launches}, expected {expect}")

    # references: the same calls with the plain versions on the card
    # (the 4096 x 4 KiB CFB and OFB batches run the ragged K13 launch that
    # phase 7 holds bit for bit against its plain version at this shape, one
    # run of 128 AES-256 words; CBC decrypt is held by its round trip)
    with plain_kernels():
        check(cb.cbc_encrypt_batch(keys256, ivs, pts, device=dev) == out["cbc enc warm"],
              "CBC batch != plain pipeline")
        check(bulk.cmac_batch(keys128, pts, device=dev) == out["cmac warm"],
              "CMAC batch != plain pipeline")
        for name, fn in ragged.items():
            check(fn() == out[name], f"{name} != plain pipeline")
    phase(15, "chain requests", f"{b} x {size >> 10} KiB AES-256 CBC (CTS)/CFB/OFB and "
          f"AES-128 CMAC batches, new and warm key set, round trips; a ragged batch of "
          f"{nrag} (AES-128/192/256 in turn, 0..4 KiB, not whole blocks) through CBC-CTS, "
          f"three paddings, CFB, OFB, ECB, CTR and CMAC, round trips; all equal the plain "
          f"pipeline (the 4096 x 4 KiB batches: CBC and CMAC); main.c ECB/CBC/CFB/OFB/CTR/CMAC "
          f"answers and {n_sample} samples per mode "
          f"through the per-message API; launches {json.dumps(launches)} (as expected "
          f"{json.dumps(expect)}); host-clock seconds per request {json.dumps(times)}")
    return launches, times


def aead_requests(dev, rng):
    """Phase 16: one-pass AEAD requests: the CCM and EAX batches at 2048 x 4
    KiB and the SIV batch at 4096 x 4 KiB (AES-128, AAD b"hdr"), each under
    a new and a warm key set with a tampered message, a ragged batch of 256
    through all three modes both ways, samples through the per-message API;
    returns the K11/K12 launch counts and the host-clock seconds per
    request."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.ops.aead_kernels import (
        aead_chain_fused,
        ctr_packed_fused,
        siv_open_chain_fused,
        siv_seal_chain_fused,
    )
    from micro_aes_tpu_torch.ops.chain_kernels import cbcmac_packed_fused
    from micro_aes_tpu_torch.ops.multikey import cipher_blocks_ragged

    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    def tamper(blob):
        return bytes([blob[0] ^ 1]) + blob[1:]

    b, nb = AEAD_SHAPE
    size = 16 * nb
    blob = rand(SIV_SHAPE[0] * size)
    pts = [blob[i * size:(i + 1) * size] for i in range(SIV_SHAPE[0])]
    aad = b"hdr"
    calls = {  # (seal, open, the batch's operands before the data)
        "ccm": (bulk.ccm_encrypt_batch, bulk.ccm_decrypt_batch,
                ([rand(16) for _ in range(b)], [rand(11) for _ in range(b)], [aad] * b)),
        "eax": (bulk.eax_encrypt_batch, bulk.eax_decrypt_batch,
                ([rand(16) for _ in range(b)], [rand(12) for _ in range(b)], [aad] * b)),
    }
    siv_keys, siv_aads = [rand(32) for _ in range(SIV_SHAPE[0])], [aad] * SIV_SHAPE[0]
    # ragged: keys of 16/24/32 bytes in turn (SIV: twice that), 0..4 KiB with
    # empty and sub-block messages, AADs of 0..40 bytes
    nrag = 256
    rlens = [int(x) for x in rng.integers(0, 4097, nrag)]
    rlens[:4] = (0, 1, 15, 16)
    rkeys = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    rsiv_keys = [k + rand(len(k)) for k in rkeys]
    rnonces = [rand(11 + i % 3) for i in range(nrag)]
    raads = [rand(int(x)) for x in rng.integers(0, 41, nrag)]
    rpts = [rand(n) for n in rlens]
    rgroups = len({len(k) for k in rkeys})

    kernels = (aead_chain_fused, siv_seal_chain_fused, siv_open_chain_fused, ctr_packed_fused,
               cbcmac_packed_fused, cipher_blocks_ragged)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    times, out = {}, {}

    def req(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        times[name] = time.perf_counter() - t0
        return out[name]

    for mode, (seal, open_, ops) in calls.items():
        for tag in ("new key set", "warm"):
            req(f"{mode} seal {tag}", lambda: seal(*ops, pts[:b], device=dev))
        check(out[f"{mode} seal new key set"] == out[f"{mode} seal warm"],
              f"{mode}: a warm batch differs from the new one")
        sealed = list(out[f"{mode} seal warm"])
        sealed[5] = tamper(sealed[5])
        got = req(f"{mode} open", lambda: open_(*ops, sealed, device=dev))
        check(got == [None if i == 5 else p for i, p in enumerate(pts[:b])],
              f"{mode} batch open: round trip and the tampered message")
    for tag in ("new key set", "warm"):
        req(f"siv seal {tag}", lambda: bulk.siv_encrypt_batch(siv_keys, siv_aads, pts,
                                                               device=dev))
    check(out["siv seal new key set"] == out["siv seal warm"], "siv: a warm batch differs")
    siv_ivs = [s[0] for s in out["siv seal warm"]]
    siv_cts = [s[1] for s in out["siv seal warm"]]
    siv_cts[5] = tamper(siv_cts[5])
    got = req("siv open", lambda: bulk.siv_decrypt_batch(siv_keys, siv_ivs, siv_aads, siv_cts,
                                                          device=dev))
    check(got == [None if i == 5 else p for i, p in enumerate(pts)],
          "siv batch open: round trip and the tampered message")
    ragged = {
        "ragged ccm": lambda: bulk.ccm_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev),
        "ragged eax": lambda: bulk.eax_encrypt_batch(rkeys, rnonces, raads, rpts, device=dev),
        "ragged siv": lambda: bulk.siv_encrypt_batch(rsiv_keys, raads, rpts, device=dev),
    }
    for name, fn in ragged.items():
        req(name, fn)
    check(req("ragged ccm open", lambda: bulk.ccm_decrypt_batch(
        rkeys, rnonces, raads, out["ragged ccm"], device=dev)) == rpts, "ragged CCM round trip")
    check(req("ragged eax open", lambda: bulk.eax_decrypt_batch(
        rkeys, rnonces, raads, out["ragged eax"], device=dev)) == rpts, "ragged EAX round trip")
    check(req("ragged siv open", lambda: bulk.siv_decrypt_batch(
        rsiv_keys, [s[0] for s in out["ragged siv"]], raads, [s[1] for s in out["ragged siv"]],
        device=dev)) == rpts, "ragged SIV round trip")
    torch.cuda.synchronize()
    launches = {"aead_chain": aead_chain_fused.launches,
                "siv_seal_chain": siv_seal_chain_fused.launches,
                "siv_open_chain": siv_open_chain_fused.launches,
                "ctr_packed": ctr_packed_fused.launches,
                "cbcmac_packed": cbcmac_packed_fused.launches,
                "multikey_ragged": cipher_blocks_ragged.launches}
    # per key-size group of each call with a non-empty message: one K11 or
    # K12 call, which is one K15 keystream pass and one K13 MAC (the K11/K12
    # counts are those two launches, taken where they launch); and the K13
    # folds before it: CCM's B0 + AAD prefix, EAX's nonce and header OMACs
    # and its tweak block, SIV's S2V AAD side (no CCM group is all empty, so
    # K9 makes no E(A0))
    ncalls = 3 + 2 * rgroups  # per mode: seal twice and open at 2048 or 4096, ragged both ways
    expect = {"aead_chain": 2 * 2 * ncalls, "siv_seal_chain": 2 * (2 + rgroups),
              "siv_open_chain": 2 * (1 + rgroups), "ctr_packed": 3 * ncalls,
              "cbcmac_packed": (2 + 4 + 2) * ncalls, "multikey_ragged": 0}
    check(launches == expect or dev.type == "cpu", f"K11/K12/K15/K13/K9 launches {launches}, "
          f"expected {expect}")
    launches.pop("multikey_ragged")
    # samples through the per-message API (their MACs on K13, CTR on the
    # byte cipher), then the same calls with the plain versions on the card
    n_sample = 0
    for i in (0, b - 1):
        (kc, nc, _), (ke, ne, _) = calls["ccm"][2], calls["eax"][2]
        check(aes.ccm_encrypt(kc[i], nc[i], aad, pts[i], device=dev) == out["ccm seal warm"][i]
              and aes.eax_encrypt(ke[i], ne[i], aad, pts[i], device=dev)
              == out["eax seal warm"][i]
              and aes.siv_encrypt(siv_keys[i], aad, pts[i], device=dev)
              == out["siv seal warm"][i], f"message {i}: per-message mode != batch")
        n_sample += 1
    for i in (0, 1, 2, 3, nrag - 1):
        check(aes.ccm_encrypt(rkeys[i], rnonces[i], raads[i], rpts[i], len(rnonces[i]),
                              device=dev) == out["ragged ccm"][i]
              and aes.eax_encrypt(rkeys[i], rnonces[i], raads[i], rpts[i], device=dev)
              == out["ragged eax"][i]
              and aes.siv_encrypt(rsiv_keys[i], raads[i], rpts[i], device=dev)
              == out["ragged siv"][i], f"ragged message {i}: per-message mode != batch")
        n_sample += 1
    with plain_kernels():
        for mode, (seal, open_, ops) in calls.items():
            check(seal(*ops, pts[:b], device=dev) == out[f"{mode} seal warm"],
                  f"{mode} batch != plain pipeline")
        check(bulk.siv_encrypt_batch(siv_keys, siv_aads, pts, device=dev)
              == out["siv seal warm"], "SIV batch != plain pipeline")
        check(bulk.siv_decrypt_batch(siv_keys, siv_ivs, siv_aads, siv_cts, device=dev)
              == out["siv open"], "SIV open batch != plain pipeline")
        for name, fn in ragged.items():
            check(fn() == out[name], f"{name} != plain pipeline")
    phase(16, "AEAD requests", f"{b} x {size >> 10} KiB AES-128 CCM (11-byte nonces) and EAX "
          f"(12-byte) batches and {SIV_SHAPE[0]} x {size >> 10} KiB AES-SIV (16 + 16-byte "
          f"keys), AAD b'hdr', new and warm key set, round trips with a tampered message; a "
          f"ragged batch of {nrag} (AES-128/192/256 in turn, 0..4 KiB, AAD 0..40 B) through "
          f"CCM, EAX and SIV both ways; all equal the plain pipeline; {n_sample} samples "
          f"through the per-message API; launches {json.dumps(launches)} (as expected); "
          f"host-clock seconds per request {json.dumps(times)}")
    return launches, times


def kw_requests(dev, rng):
    """Phase 17: RFC 3394 key-wrap requests: 2048 x 512 B secrets under
    AES-128 KEKs and 4,096 AES-256 data keys under as many 256-bit KEKs (new
    and warm key set, a tampered wrap), a ragged batch of 256 both ways, the
    main.c answers and samples through the per-message API; returns the K16
    launch counts and the host-clock seconds per request."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.ops.kw_kernels import kw_packed, kw_wheel_ragged
    from micro_aes_tpu_torch.testing import kat

    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    def tamper(blob):
        return bytes([blob[0] ^ 1]) + blob[1:]

    b, n = KW_SHAPE
    batches = {  # name: (KEKs, secrets)
        "aes-128 512 B": ([rand(16) for _ in range(b)], [rand(8 * n) for _ in range(b)]),
        "aes-256 data keys": ([rand(32) for _ in range(4096)], [rand(32) for _ in range(4096)]),
    }
    nrag = 256
    rkeks = [rand((16, 24, 32)[i % 3]) for i in range(nrag)]
    rsecrets = [rand(8 * int(x)) for x in rng.integers(2, 65, nrag)]

    for fn in (kw_packed, kw_wheel_ragged):
        fn.launches = 0
    torch.cuda.synchronize()
    times, out = {}, {}
    expect = {"kw_packed": 0, "kw_wheel_ragged": 0}

    def req(name, fn, keks, datas):
        t0 = time.perf_counter()
        out[name] = fn()
        times[name] = time.perf_counter() - t0
        expect["kw_wheel_ragged"] += 1  # one launch per batch call
        return out[name]

    tampered = {}
    for name, (keks, secrets) in batches.items():
        for tag in ("new key set", "warm"):
            req(f"{name} wrap {tag}", lambda: bulk.key_wrap_batch(keks, secrets, device=dev),
                keks, secrets)
        check(out[f"{name} wrap new key set"] == out[f"{name} wrap warm"],
              f"{name}: a warm batch differs from the new one")
        wrapped = tampered[name] = list(out[f"{name} wrap warm"])
        wrapped[5] = tamper(wrapped[5])
        got = req(f"{name} unwrap", lambda: bulk.key_unwrap_batch(keks, wrapped, device=dev),
                  keks, wrapped)
        check(got == [None if i == 5 else s for i, s in enumerate(secrets)],
              f"{name} unwrap: round trip and the tampered wrap")
    req("ragged wrap", lambda: bulk.key_wrap_batch(rkeks, rsecrets, device=dev), rkeks, rsecrets)
    rwrapped = list(out["ragged wrap"])
    rwrapped[7] = tamper(rwrapped[7])
    check(req("ragged unwrap", lambda: bulk.key_unwrap_batch(rkeks, rwrapped, device=dev),
              rkeks, rwrapped) == [None if i == 7 else s for i, s in enumerate(rsecrets)],
          "ragged KW round trip and the tampered wrap")
    # per message: the main.c answers, then samples of the batches
    for klen, want in kat.KW_VECTORS:
        kek, secret = kat.KW_KEK[:klen], kat.KW_SECRET[:klen]
        check(aes.key_wrap(kek, secret, device=dev) == want, f"main.c KW{8 * klen} on the card")
        check(aes.key_unwrap(kek, want, device=dev) == secret, f"KW{8 * klen} unwrap")
        expect["kw_packed"] += 2
    for name, (keks, secrets) in batches.items():
        for i in (0, len(keks) - 1):
            check(aes.key_wrap(keks[i], secrets[i], device=dev) == out[f"{name} wrap warm"][i],
                  f"{name} message {i}: key_wrap != batch")
            expect["kw_packed"] += 1
    for i in (0, 1, 2, nrag - 1):
        check(aes.key_wrap(rkeks[i], rsecrets[i], device=dev) == out["ragged wrap"][i]
              and aes.key_unwrap(rkeks[i], out["ragged wrap"][i], device=dev) == rsecrets[i],
              f"ragged message {i}: key_wrap/key_unwrap != batch")
        expect["kw_packed"] += 2
    torch.cuda.synchronize()
    launches = {"kw_packed": kw_packed.launches, "kw_wheel_ragged": kw_wheel_ragged.launches}
    check(launches == expect or dev.type == "cpu", f"K16 launches {launches}, expected {expect}")
    with plain_kernels():
        for name, (keks, secrets) in batches.items():
            check(bulk.key_wrap_batch(keks, secrets, device=dev) == out[f"{name} wrap warm"],
                  f"{name} wrap != plain pipeline")
            check(bulk.key_unwrap_batch(keks, tampered[name], device=dev)
                  == out[f"{name} unwrap"], f"{name} unwrap != plain pipeline")
        check(bulk.key_wrap_batch(rkeks, rsecrets, device=dev) == out["ragged wrap"],
              "ragged wrap != plain pipeline")
        check(bulk.key_unwrap_batch(rkeks, rwrapped, device=dev) == out["ragged unwrap"],
              "ragged unwrap != plain pipeline")
        for klen, want in kat.KW_VECTORS:
            check(aes.key_wrap(kat.KW_KEK[:klen], kat.KW_SECRET[:klen], device=dev) == want,
                  f"main.c KW{8 * klen} on the plain pipeline")
    nrgroups = len({(len(d), len(k)) for k, d in zip(rkeks, rsecrets)})
    phase(17, "KW requests", f"{b} x {8 * n} B secrets under AES-128 KEKs and 4096 AES-256 "
          f"data keys under 256-bit KEKs, new and warm key set, round trips with a tampered "
          f"wrap; a ragged batch of {nrag} ({nrgroups} (semiblocks, key size) groups in one "
          f"launch each way, KEKs of "
          f"16/24/32 B in turn, 16..512 B secrets) both ways with a tampered wrap; all equal "
          f"the plain pipeline; main.c KW128/192/256 and samples through key_wrap/key_unwrap; "
          f"launches {json.dumps(launches)} (as expected); host-clock seconds per request "
          f"{json.dumps(times)}")
    return launches, times


def fpe_k2_launches(method: str, tokens: int, n: int, radix: int, t: int) -> int:
    """K2 launches of one FPE batch call of `tokens` tokens of n digits
    (fpe/device): per chunk and round, FF3 encrypts one block per token and
    FF1 its nq blocks of Q plus, when d > 16, the S-expansion blocks."""
    import math

    from micro_aes_tpu_torch.fpe.device import FPE_CHUNK

    chunks = -(-(tokens + (-tokens) % 32) // FPE_CHUNK)
    if method != "ff1":
        return 8 * chunks
    b = (math.ceil((n - n // 2) * math.log2(radix)) + 7) // 8
    d = 4 * ((b + 3) // 4) + 4
    nq = (t + (-t - b - 1) % 16 + 1 + b) // 16
    return 10 * chunks * (nq + (d > 16))


def poly_fpe_compat_requests(dev, rng):
    """Phase 18: Poly1305-AES of 16 MiB on the bulk fold against the host
    Horner loop (and the main.c vector, a message at the routing boundary),
    FPE batches (FF1 and FF3-1 over 65,536 card numbers, FF1 over 4,096
    alnum_lower tokens) both ways with 64 tokens against the host path and
    the main.c vectors through both paths, and every compat function on the
    main.c vectors; returns the K2 and K13 CBC-MAC launches and the
    host-clock seconds."""
    import torch

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch import compat
    from micro_aes_tpu_torch.fpe import device as fdev
    from micro_aes_tpu_torch.modes import poly1305
    from micro_aes_tpu_torch.ops import poly_bulk
    from micro_aes_tpu_torch.ops.chain_kernels import cbcmac_packed_fused
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.testing import kat

    def rand(nbytes):
        return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def horner(keys, nonce, data):
        saved = poly1305._BULK_THRESHOLD
        poly1305._BULK_THRESHOLD = 1 << 62
        try:
            return poly1305.poly1305_aes(keys, nonce, data, device=dev)
        finally:
            poly1305._BULK_THRESHOLD = saved

    for fn in (cipher_planes, cbcmac_packed_fused):
        fn.launches = 0
    times = {}
    t_phase = time.perf_counter()

    # Poly1305-AES: AES-256 key || r; the first call builds the power tables
    keys, nonce, data = rand(48), rand(16), rand(POLY_BYTES)
    size = f"{POLY_BYTES / 2**20:g} MiB"
    tag, t_new = timed(lambda: aes.poly1305_aes(keys, nonce, data, device=dev))
    tag2, t_warm = timed(lambda: aes.poly1305_aes(keys, nonce, data, device=dev))
    want, t_horner = timed(lambda: horner(keys, nonce, data))
    check(tag == tag2 == want, f"Poly1305 {size}: the fold != the host Horner loop")
    times.update({f"poly1305 {size} fold, new r": t_new, f"poly1305 {size} fold, warm": t_warm,
                  f"poly1305 {size} host Horner loop": t_horner})
    nf = POLY_BYTES // 512 * 32  # the fold alone, over the message's whole 32-chunk groups
    words = torch.from_numpy(np.frombuffer(data, np.uint8, 16 * nf).copy()).to(dev)
    words = words.view(torch.int32).reshape(nf, 4).T
    pad = torch.ones(nf, dtype=torch.bool, device=dev)
    tables = poly_bulk.poly_power_tables(poly1305._clamp_r(keys[32:]), nf, dev)
    fold_ms = cuda_ms(lambda: poly_bulk.poly_fold(tables, words, pad), 5)
    edge = rand(poly1305._BULK_THRESHOLD + 7)
    check(aes.poly1305_aes(keys, nonce, edge, device=dev) == horner(keys, nonce, edge),
          "Poly1305 64 KiB + 7 B: the fold != the host Horner loop")
    check(aes.poly1305_aes(kat.MAIN_KEY, kat.MAIN_IV, kat.MAIN_PLAINTEXT, device=dev)
          == kat.POLY1305_128, "main.c POLY1305_128 on the card")
    check(poly1305.poly1305_aes_bulk(kat.MAIN_KEY, kat.MAIN_IV, kat.MAIN_PLAINTEXT, device=dev)
          == kat.POLY1305_128, "main.c POLY1305_128 through the bulk fold")

    # FPE batches: card numbers under FF1 (8-byte tweak) and FF3-1 (7-byte)
    key = rand(16)
    ntok, ndig = FPE_TOKENS
    cards = ["".join(map(str, row)) for row in rng.integers(0, 10, (ntok, ndig))]
    nalnum, nchar = FPE_ALNUM_TOKENS
    alnum = aes.ALPHABETS["alnum_lower"]
    words_a = ["".join(alnum.chars[i] for i in row)
               for row in rng.integers(0, alnum.radix, (nalnum, nchar))]
    batches = (("ff1", rand(8), "digits", cards), ("ff3-1", rand(7), "digits", cards),
               ("ff1", rand(8), "alnum_lower", words_a))
    k2, fpe_info = {}, {}
    for method, tweak, alphabet, toks in batches:
        name = f"{method} {alphabet} {len(toks)} x {len(toks[0])}"
        k2_0 = cipher_planes.launches
        ct, t_enc = timed(lambda: fdev.fpe_encrypt_batch(key, tweak, toks, alphabet, method,
                                                         device=dev))
        k2_enc = cipher_planes.launches - k2_0
        back, t_dec = timed(lambda: fdev.fpe_decrypt_batch(key, tweak, ct, alphabet, method,
                                                           device=dev))
        k2[name] = (k2_enc, cipher_planes.launches - k2_0 - k2_enc)
        radix = aes.ALPHABETS[alphabet].radix
        expect = fpe_k2_launches(method, len(toks), len(toks[0]), radix, len(tweak))
        check(k2[name] == (expect, expect) or dev.type == "cpu",
              f"FPE {name}: K2 launches {k2[name]}, expected {expect} per call")
        check(back == toks, f"FPE {name}: a token did not round-trip")
        check(all(len(c) == len(p) and set(c) <= set(aes.ALPHABETS[alphabet].chars)
                  for c, p in zip(ct[:FPE_HOST_SAMPLE], toks)), f"FPE {name}: format")
        idx = [int(i) for i in rng.choice(len(toks), FPE_HOST_SAMPLE, replace=False)]
        mac0 = cbcmac_packed_fused.launches
        check([aes.fpe_encrypt(key, tweak, toks[i], alphabet, method, device=dev) for i in idx]
              == [ct[i] for i in idx], f"FPE {name}: batch != host path")
        macs = cbcmac_packed_fused.launches - mac0
        check(macs == (10 * FPE_HOST_SAMPLE if method == "ff1" else 0) or dev.type == "cpu",
              f"FPE {name}: {macs} K13 CBC-MAC launches on the host path")
        times[f"fpe {name} encrypt"], times[f"fpe {name} decrypt"] = t_enc, t_dec
        fpe_info[name] = {"tokens_per_s_encrypt": len(toks) / t_enc,
                          "tokens_per_s_decrypt": len(toks) / t_dec,
                          "k2_launches_per_call": k2[name][0]}
    fkey, pt3 = kat.MAIN_KEY[:16], kat.FPE_PLAIN[:55]
    for method, tweak, pt, want in (("ff1", kat.MAIN_AAD, kat.FPE_PLAIN, kat.FPE_FF1_CIPHER),
                                    ("ff3-1", kat.MAIN_AAD[:7], pt3, kat.FPE_FF3_CIPHER)):
        check(aes.fpe_encrypt(fkey, tweak, pt, "digits", method, device=dev) == want
              and aes.fpe_decrypt(fkey, tweak, want, "digits", method, device=dev) == pt,
              f"main.c FPE {method} through the host path")
        check(fdev.fpe_encrypt_batch(fkey, tweak, [pt], "digits", method, device=dev) == [want]
              and fdev.fpe_decrypt_batch(fkey, tweak, [want], "digits", method, device=dev)
              == [pt], f"main.c FPE {method} through the batch path")

    # compat: every AES_* function on the main.c vectors
    t0 = time.perf_counter()
    key, iv, aad, pt, ok = kat.MAIN_KEY[:16], kat.MAIN_IV, kat.MAIN_AAD, kat.MAIN_PLAINTEXT, 0
    c = compat
    ocb128 = kat.OCB_VECTORS[0][5]
    auth = c.M_AUTHENTICATION_ERROR

    def tamper(blob):
        return blob[:-1] + bytes([blob[-1] ^ 1])

    checks = {
        "AES_Cipher": c.AES_Cipher(kat.FIPS_KEY128, "E", kat.FIPS_PT, device=dev) == kat.FIPS_CT128
        and c.AES_Cipher(kat.FIPS_KEY128, "D", kat.FIPS_CT128, device=dev) == kat.FIPS_PT,
        "AES_ECB": c.AES_ECB_encrypt(key, pt, device=dev) == kat.ECB128
        and c.AES_ECB_decrypt(key, kat.ECB128, device=dev)[1][:len(pt)] == pt,
        "AES_CBC": c.AES_CBC_encrypt(key, iv, pt, device=dev) == (ok, kat.CBC128_CTS)
        and c.AES_CBC_decrypt(key, iv, kat.CBC128_CTS, device=dev) == (ok, pt),
        "AES_CFB": c.AES_CFB_encrypt(key, iv, pt, device=dev) == kat.CFB128
        and c.AES_CFB_decrypt(key, iv, kat.CFB128, device=dev) == pt,
        "AES_OFB": c.AES_OFB_encrypt(key, iv, pt, device=dev) == kat.OFB128
        and c.AES_OFB_decrypt(key, iv, kat.OFB128, device=dev) == pt,
        "AES_CTR": c.AES_CTR_encrypt(key, iv, pt, device=dev) == kat.CTR128
        and c.AES_CTR_decrypt(key, iv, kat.CTR128, device=dev) == pt,
        "AES_CMAC": c.AES_CMAC(key, pt, device=dev) == kat.CMAC128,
        "AES_Poly1305": c.AES_Poly1305(kat.MAIN_KEY, iv, pt, device=dev) == kat.POLY1305_128,
        "AES_FPE": c.AES_FPE_encrypt(key, aad, kat.FPE_PLAIN, device=dev)
        == (ok, kat.FPE_FF1_CIPHER)
        and c.AES_FPE_decrypt(key, aad, kat.FPE_FF1_CIPHER, device=dev) == (ok, kat.FPE_PLAIN)
        and c.AES_FPE_encrypt(key, b"", "123", device=dev)[0] == c.M_ENCRYPTION_ERROR,
    }
    for name, (_, keys2, tweak, xpt, xct) in zip(("AES_XTS 128", "AES_XTS 256"), kat.XTS_VECTORS):
        checks[name] = (c.AES_XTS_encrypt(keys2, tweak, xpt, device=dev) == (ok, xct)
                        and c.AES_XTS_decrypt(keys2, tweak, xct, device=dev) == (ok, xpt))
    for name, enc, dec, nonce, want in (
            ("AES_GCM", c.AES_GCM_encrypt, c.AES_GCM_decrypt, iv[:12], kat.GCM128),
            ("AES_CCM", c.AES_CCM_encrypt, c.AES_CCM_decrypt, iv[:11], kat.CCM128),
            ("AES_OCB", c.AES_OCB_encrypt, c.AES_OCB_decrypt, iv[:12], ocb128),
            ("AES_EAX", c.AES_EAX_encrypt, c.AES_EAX_decrypt, iv, kat.EAX128),
            ("GCM_SIV", c.GCM_SIV_encrypt, c.GCM_SIV_decrypt, iv[:12], kat.GCMSIV128)):
        checks[name] = (enc(key, nonce, aad, pt, device=dev) == want
                        and dec(key, nonce, aad, want, device=dev) == (ok, pt)
                        and dec(key, nonce, aad, tamper(want), device=dev) == (auth, b""))
    siv_iv, siv_ct = c.AES_SIV_encrypt(kat.MAIN_KEY, aad, pt, device=dev)
    checks["AES_SIV"] = (siv_iv + siv_ct == kat.SIV128
                         and c.AES_SIV_decrypt(kat.MAIN_KEY, siv_iv, aad, siv_ct, device=dev)
                         == (ok, pt)
                         and c.AES_SIV_decrypt(kat.MAIN_KEY, tamper(siv_iv), aad, siv_ct,
                                               device=dev) == (auth, b""))
    for klen, want in kat.KW_VECTORS:
        kek, secret = kat.KW_KEK[:klen], kat.KW_SECRET[:klen]
        checks[f"AES_KEY {8 * klen}"] = (
            c.AES_KEY_wrap(kek, secret, device=dev) == (ok, want)
            and c.AES_KEY_unwrap(kek, want, device=dev) == (ok, secret)
            and c.AES_KEY_unwrap(kek, tamper(want), device=dev) == (auth, b""))
    checks["AES_KEY short secret"] = (c.AES_KEY_wrap(kat.KW_KEK[:16], b"1234567", device=dev)
                                      == (c.M_DATALENGTH_ERROR, b""))
    torch.cuda.synchronize()
    times["compat"] = time.perf_counter() - t0
    failed = [name for name, good in checks.items() if not good]
    check(not failed, f"compat on the main.c vectors: {failed}")

    launches = {"cipher_planes": cipher_planes.launches,
                "cbcmac_packed": cbcmac_packed_fused.launches}
    phase(18, "Poly1305, FPE and compat requests",
          f"Poly1305-AES of {size} under an AES-256 key on the bulk fold equals the host "
          f"Horner loop (fold {fold_ms:.4f} ms on the card by CUDA events; host-clock s: new "
          f"r {t_new:.4f}, warm {t_warm:.4f}, Horner {t_horner:.4f}), 64 KiB + 7 B too, main.c "
          f"POLY1305_128 both ways; FPE batches {json.dumps(fpe_info)}: every token "
          f"round-trips, {FPE_HOST_SAMPLE} a batch equal the host path, K2 launches "
          f"(encrypt, decrypt) {json.dumps(k2)} as expected, the host path's FF1 on K13 "
          f"(10 CBC-MAC launches a token), main.c FF1/FF3-1 through both paths; {len(checks)} "
          f"compat checks on the main.c vectors (tampered tags, a short KW secret) in "
          f"{times['compat']:.4f} s; launches {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.3f} s; host-clock seconds {json.dumps(times)}")
    return launches, times


def sharded_requests(dev, rng):
    """Phase 19: the sharded paths (micro_aes_tpu_torch.parallel) in a
    process group of world size 1 on the card (NCCL; gloo on the CPU), a
    FileStore in a temporary directory and the finite PG_TIMEOUT; the group
    is destroyed at the end.  The sp-sharded fused GCM on a (1, 1) mesh for
    the `full` profile (16 MiB AES-256, 12-byte nonce, 1 KiB AAD) seals and
    opens against gcm_seal/gcm_open; the same message as SHARDS shards in
    this one process (the per-shard body on K1 at start = s*L - 1, the
    partials XORed on the card) against gcm_seal: one card checks the
    cross-shard algebra, ranks above 1 are checked only on the CPU
    (tests/test_torch_parallel.py); the K2 engine at 1 MiB; each dp twin at
    the batch phases' shapes against the port's unsharded batch API.  The
    references and the twins' operands are made first, then every count is
    set to 0, the sharded calls run twice each (host clock, synchronised,
    the warm second run reported), and the counts are read and checked
    exactly.  Returns the launch counts and the
    host-clock seconds."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch import parallel as par
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.core.cipher import encrypt_blocks_np
    from micro_aes_tpu_torch.modes import bulk, chain_bulk, seal, seal_batch, xts_bulk
    from micro_aes_tpu_torch.modes.ccm import _iv0
    from micro_aes_tpu_torch.ops.aead_kernels import ctr_packed_fused
    from micro_aes_tpu_torch.ops.chain import gcm_chain_fused_raw
    from micro_aes_tpu_torch.ops.chain_kernels import (
        cbcmac_packed_fused,
        chain_packed_fused,
        chain_packed_ragged,
        ofb_packed_fused,
    )
    from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes
    from micro_aes_tpu_torch.ops.mac import cbcmac_fold_batch_auto, ghash_fold_batch
    from micro_aes_tpu_torch.ops.multikey import cipher_blocks_ragged, ctrw_multikey_rks
    from micro_aes_tpu_torch.ops.seal_kernels import seal_fused
    from micro_aes_tpu_torch.ops.xex_kernels import xex_fused

    t_phase = time.perf_counter()

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def on_dev(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn, reps=2):
        """fn's result and the host-clock seconds of its last run (the first
        takes any new key's setup)."""
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
        return out, time.perf_counter() - t0

    def j0_rows(nonces):
        j0 = np.zeros((len(nonces), 16), np.uint8)
        j0[:, :12] = np.frombuffer(b"".join(nonces), np.uint8).reshape(-1, 12)
        j0[:, 15] = 1
        return j0

    counters = {"seal_fused": seal_fused, "cipher_planes": cipher_planes,
                "multikey": ctrw_multikey_rks, "xex_fused": xex_fused,
                "gcm_chain": gcm_chain_fused_raw, "chain_packed": chain_packed_fused,
                "ofb_packed": ofb_packed_fused, "ctr_packed": ctr_packed_fused,
                "cbcmac_packed": cbcmac_packed_fused, "multikey_ragged": cipher_blocks_ragged,
                "chain_packed_ragged": chain_packed_ragged}
    times, runs = {}, []   # runs: (name, sharded call, its check)

    # the sp-sharded fused GCM: 16 MiB AES-256, 1 KiB AAD, one shard and SHARDS
    n = MIB16_BLOCKS
    key, nonce, aad = rand(32), rand(12), rand(AAD_BYTES)
    pt = rand(16 * n)
    sealed, times["gcm_seal_s"] = timed(lambda: aes.gcm_seal(key, nonce, pt, aad, device=dev))
    _, times["gcm_open_s"] = timed(lambda: aes.gcm_open(key, nonce, sealed, aad, device=dev))
    kp, tables = seal.gcm_key_setup(key, device=dev)
    j0 = j0_rows([nonce])
    j0_t, ek_t = on_dev(j0), on_dev(encrypt_blocks_np(key, j0))
    acc, shift, alen = par.sharded_aad_args(key, aad, n, 1, device=dev)
    pt_t = on_dev(np.frombuffer(pt, np.uint8).reshape(1, n, 16))
    ct_t = on_dev(np.frombuffer(sealed[:-16], np.uint8).reshape(1, n, 16))
    adj1 = par.shard_adjust_matrices_fused(tables[3], n, 1, device=dev)
    adjs = par.shard_adjust_matrices_fused(tables[3], n // SHARDS, SHARDS, device=dev)

    def blob(out, tag):
        return out.cpu().numpy().tobytes() + tag.cpu().numpy().tobytes()

    def check_open(res):
        out, tag = res
        check(blob(out, tag) == pt + sealed[-16:], "sharded open != gcm_open (or its tag)")

    def shards_in_process():
        l = n // SHARDS
        outs, g = [], 0
        for s in range(SHARDS):
            out, g_s = par.fused_shard_body(kp, tables, adjs[s], j0_t, pt_t[:, s * l:(s + 1) * l],
                                            s, l)
            outs.append(out)
            g = g ^ g_s
        return torch.cat(outs, 1), par.sharded_tags(tables, g, ek_t, acc, shift, n, alen)

    mesh_runs = [
        ("fused_seal", lambda: par.gcm_sharded_fused_fn(mesh, n, aad_bytes=alen)(
            kp, tables, adj1, j0_t, ek_t, pt_t, acc, shift),
         lambda r: check(blob(*r) == sealed, "sharded seal != gcm_seal")),
        ("fused_open", lambda: par.gcm_sharded_fused_fn(mesh, n, aad_bytes=alen,
                                                        open_direction=True)(
            kp, tables, adj1, j0_t, ek_t, ct_t, acc, shift), check_open),
        (f"fused_seal_{SHARDS}_shards", shards_in_process,
         lambda r: check(blob(*r) == sealed, f"{SHARDS} shards != gcm_seal"))]

    # the K2 engine at 1 MiB
    n2 = K2_SHARDED_BLOCKS
    nonce2, pt2 = rand(12), rand(16 * n2)
    sealed2, times["gcm_seal_1mib_s"] = timed(lambda: aes.gcm_seal(key, nonce2, pt2, device=dev))
    j02 = j0_rows([nonce2])
    k2_args = (kp, tables, par.shard_adjust_matrices(tables[3], n2, 1, device=dev), on_dev(j02),
               on_dev(encrypt_blocks_np(key, j02)), on_dev(np.frombuffer(pt2, np.uint8)
                                                           .reshape(1, n2, 16)))
    mesh_runs.append(("k2_seal_1mib", lambda: par.gcm_seal_sharded_fn(mesh, n2)(*k2_args),
                      lambda r: check(blob(*r) == sealed2, "sharded K2 seal != gcm_seal")))

    # the multi-key GCM batch, 1024 x 16 KB AES-128 with TLS AADs: the matrix
    # core on K9 (seal_batch twin) and the value chain on K10 (gcm_chain twin)
    b, size = BATCH_SHAPES[0]
    keys = [rand(16) for _ in range(b)]
    nonces = [rand(12) for _ in range(b)]
    aads = [rand(TLS_AAD_BYTES) for _ in range(b)]
    pts = [rand(size) for _ in range(b)]
    api, times["gcm_seal_batch_s"] = timed(lambda: aes.gcm_seal_batch(keys, nonces, aads, pts,
                                                                       device=dev))
    bb, wm, _, ns, front, *core_args = seal_batch._prep(keys, nonces, aads, pts, device=dev)

    def check_core(res):
        words = res[0].cpu().numpy().view(np.uint32).reshape(bb, -1)
        tags = res[1].cpu().numpy()
        check([words[i, 4 * front[i]: 4 * (front[i] + ns[i])].tobytes() + tags[i].tobytes()
               for i in range(bb)] == api, "seal_batch twin != gcm_seal_batch")

    rks = bulk.stack_round_keys(keys)
    rks_t = on_dev(rks)
    j0b = j0_rows(nonces)
    h = bulk._enc1_batch(rks_t, torch.zeros((b, 16), dtype=torch.uint8, device=dev))
    c0 = j0b.copy()
    c0[:, 15] = 2
    aadb = np.zeros((b, 1, 16), np.uint8)
    aadb[:, 0, :TLS_AAD_BYTES] = np.frombuffer(b"".join(aads), np.uint8).reshape(b, -1)
    lenb = np.frombuffer(b"".join((8 * TLS_AAD_BYTES).to_bytes(8, "big")
                                  + (8 * size).to_bytes(8, "big") for _ in range(b)), np.uint8)
    chain_args = (rks_t, h, bulk._enc1_batch(rks_t, on_dev(j0b)), on_dev(c0),
                  ghash_fold_batch(h, torch.zeros_like(h), on_dev(aadb), [1] * b),
                  on_dev(np.frombuffer(b"".join(pts), np.uint8).reshape(b, -1, 16)),
                  on_dev(np.full(b, size // 16, np.int32)), on_dev(lenb.reshape(b, 16)))

    def check_chain(res):
        out, tags = (x.cpu().numpy() for x in res)
        check([out[i].tobytes() + tags[i].tobytes() for i in range(b)] == api,
              "gcm_chain twin != gcm_seal_batch")

    mesh_runs += [("seal_batch_twin", lambda: par.seal_batch_sharded_fn(mesh, bb, wm)(*core_args),
                   check_core),
                  ("gcm_chain_twin", lambda: par.gcm_chain_sharded_fn(mesh)(*chain_args),
                   check_chain)]

    # XTS-256 over 4,096 x 4 KiB sectors, both ways
    nsec, sector = XTS_SECTORS
    xkeys, data = rand(64), rand(nsec * sector)
    ids = list(range(nsec))
    xts_ct, times["xts_seal_sectors_s"] = timed(
        lambda: xts_bulk.xts_seal_sectors(xkeys, ids, data, sector, device=dev))
    kp1, kp2 = xts_bulk._xts_key_setup(xkeys, dev)
    tweaks = np.zeros((nsec, 16), np.uint8)
    tweaks[:, :8] = np.arange(nsec, dtype="<u8").view(np.uint8).reshape(nsec, 8)
    rows = nsec * sector // 512

    def stream(raw):
        return on_dev(seal.host_stream(raw, 0, rows).view(np.int32))

    xts_in, xts_back = stream(data), stream(xts_ct)
    for decrypt, src, want in ((False, xts_in, xts_ct), (True, xts_back, data)):
        mesh_runs.append((f"xts_{'open' if decrypt else 'seal'}_twin",
                          lambda d=decrypt, x=src: par.xts_sectors_sharded_fn(
                              mesh, sector // 512, decrypt=d)(kp1, kp2, on_dev(tweaks), x),
                          lambda r, w=want: check(r.cpu().numpy().tobytes() == w,
                                                  "XTS twin != xts_seal_sectors")))

    # the chains, 4096 x 4 KiB AES-256
    cb, cnb = CHAIN_SHAPE
    ckeys = [rand(32) for _ in range(cb)]
    civs = [rand(16) for _ in range(cb)]
    cmsgs = [rand(16 * cnb) for _ in range(cb)]
    refs = {"cbc": lambda: chain_bulk.cbc_encrypt_batch(ckeys, civs, cmsgs, cts=False,
                                                        device=dev),
            "cfb": lambda: chain_bulk.cfb_encrypt_batch(ckeys, civs, cmsgs, device=dev),
            "ofb": lambda: chain_bulk.ofb_xcrypt_batch(ckeys, civs, [bytes(16 * cnb)] * cb,
                                                       device=dev)}
    kpw = on_dev(key_planes_packed(bulk.stack_round_keys(ckeys)).view(np.int32))
    ivs_t = on_dev(np.frombuffer(b"".join(civs), np.uint8).reshape(cb, 16))
    cblocks = on_dev(np.frombuffer(b"".join(cmsgs), np.uint8).reshape(cb, cnb, 16))
    for kind, ref in refs.items():
        want, times[f"{kind}_batch_s"] = timed(ref)
        mesh_runs.append((f"{kind}_twin", lambda k=kind: par.chain_sharded_fn(mesh, k)(
            kpw, ivs_t, cnb if k == "ofb" else cblocks),
            lambda r, w=want, k=kind: check([x.tobytes() for x in r.cpu().numpy()
                                             .reshape(cb, -1)] == w, f"{k} twin != batch")))

    # CCM and EAX, 2048 x 4 KiB AES-128, AAD b"hdr"
    ab, anb = AEAD_SHAPE
    asize = 16 * anb
    hdr = b"hdr"
    akeys = [rand(16) for _ in range(ab)]
    apts = [rand(asize) for _ in range(ab)]
    ablocks = on_dev(np.frombuffer(b"".join(apts), np.uint8).reshape(ab, anb, 16))
    arks = bulk.stack_round_keys(akeys)
    zeros = torch.zeros((ab, 16), dtype=torch.uint8, device=dev)
    full = on_dev(np.full((ab, 16), 0xFF, np.uint8))
    nvalid = on_dev(np.full(ab, anb, np.int32))
    ccm_nonces = [rand(11) for _ in range(ab)]
    ccm_api, times["ccm_encrypt_batch_s"] = timed(
        lambda: bulk.ccm_encrypt_batch(akeys, ccm_nonces, [hdr] * ab, apts, device=dev))
    iv0s = np.stack([_iv0(x) for x in ccm_nonces])
    pb, nv1 = bulk._ccm_prefix_batch(iv0s, [np.frombuffer(hdr, np.uint8)] * ab, [asize] * ab, 16)
    ccm_args = (on_dev(arks), on_dev(iv0s), cbcmac_fold_batch_auto(arks, zeros, on_dev(pb), nv1),
                ablocks, nvalid, full, zeros)
    eax_nonces = [rand(12) for _ in range(ab)]
    eax_api, times["eax_encrypt_batch_s"] = timed(
        lambda: bulk.eax_encrypt_batch(akeys, eax_nonces, [hdr] * ab, apts, device=dev))
    k1, k2 = bulk._cmac_subkeys(arks, dev)

    def omac(t, strings):
        return bulk._cmac_batch(arks, k1, k2, [np.concatenate([np.eye(16, dtype=np.uint8)[15] * t,
                                                               np.frombuffer(x, np.uint8)])
                                               for x in strings], dev)

    n_mac, h_mac = omac(0, eax_nonces), omac(1, [hdr] * ab)
    tweak, lastadd, nv = bulk._eax_last_np(k1, k2, 2, [asize] * ab)
    eax_args = (on_dev(arks), n_mac, cbcmac_fold_batch_auto(arks, zeros, on_dev(tweak),
                                                            np.ones(ab, np.int32)),
                ablocks, on_dev(nv), full, on_dev(lastadd))

    def check_aead(name, res, api_out, tag_of):
        out, tag = res
        out, tag = out.cpu().numpy(), tag_of(tag).cpu().numpy()
        check([out[i].tobytes() + tag[i].tobytes() for i in range(ab)] == api_out,
              f"{name} twin != the batch API")

    mesh_runs += [("ccm_twin", lambda: par.aead_sharded_fn(mesh, "ccm")(*ccm_args),
                   lambda r: check_aead("ccm", r, ccm_api, lambda t: t)),
                  ("eax_twin", lambda: par.aead_sharded_fn(mesh, "eax")(*eax_args),
                   lambda r: check_aead("eax", r, eax_api, lambda t: n_mac ^ h_mac ^ t))]

    # SIV, 4096 x 4 KiB, 16 + 16-byte keys, AAD b"hdr"
    sb, snb = SIV_SHAPE
    skeys = [rand(32) for _ in range(sb)]
    spts = [rand(16 * snb) for _ in range(sb)]
    siv_api, times["siv_encrypt_batch_s"] = timed(
        lambda: bulk.siv_encrypt_batch(skeys, [hdr] * sb, spts, device=dev))
    rks1 = bulk.stack_round_keys([k[:16] for k in skeys])
    d, q = bulk._cmac_subkeys(rks1, dev)
    y = bulk._s2v_y(rks1, d, q, [np.frombuffer(hdr, np.uint8)] * sb, dev)
    tail, lastadd, prevadd, nv = bulk._siv_s2v_consts(d, q, y, [16 * snb] * sb)
    siv_args = (on_dev(rks1), on_dev(bulk.stack_round_keys([k[16:] for k in skeys])),
                torch.zeros((sb, 16), dtype=torch.uint8, device=dev),
                on_dev(np.frombuffer(b"".join(spts), np.uint8).reshape(sb, snb, 16)),
                *(on_dev(a) for a in (nv, tail, lastadd, prevadd)))

    def check_siv(res):
        ct, iv = (x.cpu().numpy() for x in res)
        check([(iv[i].tobytes(), ct[i].tobytes()) for i in range(sb)] == siv_api,
              "SIV twin != siv_encrypt_batch")

    mesh_runs.append(("siv_twin", lambda: par.siv_sharded_fn(mesh)(*siv_args), check_siv))

    # the sharded calls, inside the process group, counted from 0
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(par.backend_for(dev), store=store, rank=0, world_size=1,
                                timeout=par.PG_TIMEOUT)
        try:
            mesh = par.make_mesh(1, 1, device=dev)
            results = {}
            for fn in counters.values():
                fn.launches = 0
            for name, run, _ in mesh_runs:
                results[name], times[name + "_s"] = timed(run)
            launches = {name: fn.launches for name, fn in counters.items()}
        finally:
            dist.destroy_process_group()
    for name, _, verify in mesh_runs:
        verify(results[name])
    # per run of every call (each ran twice) K1: seal and open on one shard,
    # SHARDS shards; K2: the K2 engine's cipher and the XTS tweaks both ways;
    # K9's uniform entry: the matrix core; K6: XTS both ways; K13: CBC, CFB,
    # OFB, and the MACs of CCM, EAX and SIV beside their K15 passes; nothing
    # takes a ragged entry
    expect = {name: 2 * c for name, c in (
        ("seal_fused", 2 + SHARDS), ("cipher_planes", 3), ("multikey", 1), ("xex_fused", 2),
        ("gcm_chain", 1), ("chain_packed", 2), ("ofb_packed", 1), ("ctr_packed", 3),
        ("cbcmac_packed", 3), ("multikey_ragged", 0), ("chain_packed_ragged", 0))}
    check(launches == expect or dev.type == "cpu", f"sharded launches {launches}, "
          f"expected {expect}")
    phase(19, "sharded", f"{par.backend_for(dev)} group of world size 1 on {dev}; "
          f"gcm_sharded_fused_fn (1, 1) seal+open of {16 * n >> 20} MiB AES-256 with {AAD_BYTES} B AAD = "
          f"gcm_seal/gcm_open, {SHARDS} shards of {n // SHARDS} blocks in this process (K1 at "
          f"start = s*L - 1, partials XORed on the card) = gcm_seal, gcm_seal_sharded_fn at "
          f"{16 * n2 >> 20} MiB = gcm_seal; dp twins at world size 1 = the unsharded APIs: "
          f"seal_batch and gcm_chain {b} x {size >> 10} KB, XTS {nsec} x {sector >> 10} KiB "
          f"both ways, CBC/CFB/OFB {cb} x {16 * cnb >> 10} KiB, CCM/EAX {ab} x {asize >> 10} KiB, "
          f"SIV {sb} x {16 * snb >> 10} KiB; launches {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.3f} s; host-clock seconds {json.dumps(times)}")
    return launches, times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from micro_aes_tpu_torch.ops import _build

    # serving processes commonly allow TF32; the GF(2) products outside the
    # kernels are float64 (ops/ghash_bulk.py) and must stay exact under it
    torch.set_float32_matmul_precision("high")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    phase(1, "device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s); "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    _build.load()
    phase(2, "build", f"{time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_info.seconds:.3f} s) -> {_build.build_info.path.name}")
    for ln in ptxas_summary(_build.build_info.log):
        print(f"  ptxas {ln}")

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = Results()
    single_key_kernels(dev, rng, gen, res)
    batch_kernels(dev, rng, gen, res)
    siv_kernels(dev, rng, gen, res)
    xex_kernels(dev, rng, gen, res)
    floors = chain_kernels(dev, rng, gen, res)
    floors.update(aead_kernels(dev, rng, gen, res))
    floors.update(wheel_kernels(dev, rng, gen, res))
    res.require_exact()
    for name, r in res.times.items():
        floor = f", latency floor {floors[name]:.4f} ms" if name in floors else ""
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){floor}")
    # K14, K16's wide map and K9's uniform entry are on no path of phases
    # 10-18: their counts from here to phase 18 must stay 0
    from micro_aes_tpu_torch.ops.chain_kernels import (
        chain_packed_fused_wide,
        ofb_packed_fused_wide,
    )
    from micro_aes_tpu_torch.ops.kw_kernels import kw_packed_fused
    from micro_aes_tpu_torch.ops.multikey import ctrw_multikey_rks
    off_path = {"chain_packed_wide": chain_packed_fused_wide,
                "ofb_packed_wide": ofb_packed_fused_wide, "kw_packed_fused": kw_packed_fused,
                "multikey": ctrw_multikey_rks}
    for fn in off_path.values():
        fn.launches = 0
    anchors(dev, rng)
    launches = single_key_requests(dev, rng)
    batch_launches, _ = batch_requests(dev, rng)
    launches.update(batch_launches)
    siv_launches, _ = siv_requests(dev, rng)
    launches.update(siv_launches)
    xts_launches, _ = xts_ocb_requests(dev, rng)
    chain_launches, _ = chain_requests(dev, rng)
    aead_launches, _ = aead_requests(dev, rng)
    launches.update(aead_launches)
    kw_launches, _ = kw_requests(dev, rng)
    launches.update(kw_launches)
    api_launches, _ = poly_fpe_compat_requests(dev, rng)
    # K2 runs the XTS tweaks and the FPE batches' PRF, K9 chains, K13's
    # CBC-MAC FF1's host path
    for name, count in (*xts_launches.items(), *chain_launches.items(),
                        *api_launches.items()):
        launches[name] = launches.get(name, 0) + count
    check(all(v > 0 for k, v in launches.items() if k != "ctrw_fused"),
          f"a kernel never launched: {launches}")
    check(all(fn.launches == 0 for fn in off_path.values()),
          f"K14, K16's wide map or K9's uniform entry launched in phases 10-18: "
          f"{ {name: fn.launches for name, fn in off_path.items()} }")
    # phase 19 counts its own window from 0: K9's uniform entry serves the
    # matrix-GHASH twin there, and only there
    sharded_launches, _ = sharded_requests(dev, rng)
    for name, count in sharded_launches.items():
        launches[name] = launches.get(name, 0) + count
    for name, fn in off_path.items():
        if name != "multikey":
            launches[name] = fn.launches
    check(all(launches[name] == 0 for name in off_path if name != "multikey"),
          f"K14 or K16's wide map launched on a path that should not reach them: {launches}")
    phase(20, "launches", json.dumps(launches))

    # one row per kernel: its CUDA source, the TPU wrapper it replaces, and
    # the results it covers (the first is the timed main direction); K11 and
    # K12 are each a K15 and a K13 launch, composed in ops/aead_kernels.py,
    # and their launches are those two kernels' launches on their behalf
    rows = {"seal_fused": ("seal_fused.cu", "pallas_seal.py:840",
                           ("seal_fused", "seal_fused_open", "seal_fused_t")),
            "cipher_planes": ("cipher_planes.cu", "pallas_cipher.py:91",
                              ("cipher_planes", "cipher_planes_dec")),
            "ctr_fused": ("ctr_fused.cu", "pallas_seal.py:812", ("ctr_fused",)),
            "multikey": ("multikey.cu", "pallas_multikey.py:68", ("multikey", "multikey_dec")),
            "multikey_ragged": ("multikey.cu", "pallas_multikey.py:68", ("multikey_ragged",)),
            "gcm_chain": ("gcm_chain.cu", "pallas_chain.py:1388", ("gcm_chain", "gcm_chain_open")),
            "ghash1_fused": ("siv_fused.cu", "pallas_seal.py:504",
                             ("ghash1_fused", "ghash1_fused_t")),
            "siv_ctrw_fused": ("siv_fused.cu", "pallas_seal.py:581",
                               ("siv_ctrw_fused", "siv_ctrw_fused_t")),
            "siv_open_fused": ("siv_fused.cu", "pallas_seal.py:620", ("siv_open_fused",)),
            "xex_fused": ("xex_fused.cu", "pallas_seal.py:428", ("xex_fused", "xex_fused_dec")),
            "ocb_fused": ("xex_fused.cu", "pallas_seal.py:721", ("ocb_fused", "ocb_fused_dec")),
            "ctrw_fused": ("xex_fused.cu", "pallas_seal.py:784", ("ctrw_fused", "ctrw_fused_dec")),
            "chain_packed": ("chain_packed.cu", "pallas_chain.py:275",
                             ("chain_packed", "chain_packed_cfb")),
            "ofb_packed": ("chain_packed.cu", "pallas_chain.py:329", ("ofb_packed",)),
            "cbcmac_packed": ("chain_packed.cu", "pallas_chain.py:877", ("cbcmac_packed",)),
            "aead_chain": ("ops/aead_kernels.py", "pallas_chain.py:791",
                           ("aead_chain_ccm", "aead_chain_ccm_open", "aead_chain_eax",
                            "aead_chain_eax_open")),
            "siv_seal_chain": ("ops/aead_kernels.py", "pallas_chain.py:1019",
                               ("siv_seal_chain",)),
            "siv_open_chain": ("ops/aead_kernels.py", "pallas_chain.py:1135",
                               ("siv_open_chain",)),
            "kw_packed": ("kw_wheel.cu", "pallas_chain.py:477",
                          ("kw_packed", "kw_packed_unwrap", "kw_packed_fused",
                           "kw_packed_fused_unwrap")),
            "kw_wheel_ragged": ("kw_wheel.cu", "pallas_chain.py:477", ("kw_wheel_ragged",)),
            "chain_packed_ragged": ("chain_packed.cu", "pallas_chain.py:275",
                                    ("chain_packed_ragged",)),
            "chain_packed_wide": ("chain_packed.cu", "pallas_chain.py:548",
                                  ("chain_packed_wide", "chain_packed_wide_cfb")),
            "ofb_packed_wide": ("chain_packed.cu", "pallas_chain.py:605", ("ofb_packed_wide",)),
            "ctr_packed": ("aead_chain.cu", "pallas_chain.py:681", ("ctr_packed",))}
    kernels = []
    for kernel, (source, tpu, names) in rows.items():
        t = res.times[names[0]]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"micro_aes_tpu_torch/{source if '/' in source else 'csrc/' + source}",
            "replaces": f"micro_aes_tpu/ops/{tpu}", "launches": launches[kernel],
            "max_abs_err": max(res.errs[name] for name in names),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
