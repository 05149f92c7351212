"""Parity of the port's redesigned K9 entries and of the split one-pass AEAD
chains with the JAX package and with their monolithic plain versions, on
the CPU, where every wrapper runs its plain version.

K9's ragged entry (ops/multikey.cipher_blocks_ragged) runs a whole batch of
messages of any lengths and key sizes in one launch; its plain version is
held against the uniform plain version per key-size group and against the
JAX package's modes/bulk.cipher_blocks_multikey on the batch zero-padded to
its longest message (off the TPU that runs its vmapped gather cipher, one
jitted compile per key size and direction).  K11 and K12 now run as two
steps, K15's keystream pass and K13's MAC with the last-step constants
(ops/aead_kernels); the two steps on the plain versions are held against
the monolithic plain versions here (tests/test_torch_aead.py and
test_torch_siv_chain.py hold the same two steps against the JAX twins of
the kernels at these shapes).  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.bulk as jbulk

from micro_aes_tpu_torch.core.bitslice import key_planes_batch, key_planes_packed
from micro_aes_tpu_torch.modes import bulk as tbulk
from micro_aes_tpu_torch.modes.bulk import stack_round_keys
from micro_aes_tpu_torch.ops import aead_kernels as ak
from micro_aes_tpu_torch.ops import chain_kernels as ck
from micro_aes_tpu_torch.ops import multikey as mk
from micro_aes_tpu_torch.utils.bytesio import u32_tensor

CPU = "cpu"
# a ragged batch: keys of 16/24/32 bytes in turn, 0-70 blocks, empty messages
NBLOCKS = (0, 1, 31, 32, 33, 70, 0, 5, 64, 2, 17, 40)


def _keys(rng, n):
    return [rng.integers(0, 256, (16, 24, 32)[i % 3], dtype=np.uint8).tobytes()
            for i in range(n)]


def test_multikey_layout_pins_rows():
    """Rows of 32 blocks per message (the last one partial), AES-256 first,
    each rounds group padded to whole warps with idle rows under its last
    message's key; every block lies in exactly one row."""
    keys = _keys(np.random.default_rng(1), len(NBLOCKS))
    lay = mk.multikey_layout(keys, NBLOCKS)
    krow, rounds, first, valid = lay.desc.T.astype(np.int64)
    assert lay.nblocks == sum(NBLOCKS) and len(lay.desc) % 32 == 0
    assert list(lay.offsets) == list(np.cumsum((0,) + NBLOCKS[:-1]))
    assert list(dict.fromkeys(rounds)) == [14, 12, 10]
    for r in (14, 12, 10):
        rows = lay.desc[rounds == r]
        assert len(rows) % 32 == 0 and rows[-1, 3] == 0
        msgs = [i for i, k in enumerate(keys) if len(k) // 4 + 6 == r and NBLOCKS[i]]
        assert (rows[valid[rounds == r] == 0, 0] == 15 * msgs[-1]).all()
    covered = np.zeros(lay.nblocks, np.int64)
    for k, r, f, v in lay.desc.astype(np.int64):
        m = k // 15  # the row's message: its round keys and its blocks
        assert k % 15 == 0 and 0 <= v <= 32 and r == len(keys[m]) // 4 + 6
        if v:
            assert (f - lay.offsets[m]) % 32 == 0 and f + v <= lay.offsets[m] + NBLOCKS[m]
        covered[f:f + v] += 1
    assert (covered == 1).all()
    with pytest.raises(ValueError):
        mk.cipher_blocks_ragged(mk.layout_round_keys(keys, CPU), lay.desc[:-1],
                                torch.zeros((lay.nblocks, 16), dtype=torch.uint8))


def _ragged_case(seed):
    rng = np.random.default_rng(seed)
    keys = _keys(rng, len(NBLOCKS))
    lay = mk.multikey_layout(keys, NBLOCKS)
    blocks = rng.integers(0, 256, (lay.nblocks, 16), dtype=np.uint8)
    return keys, lay, blocks


@pytest.mark.parametrize("decrypt", (False, True), ids=("encrypt", "decrypt"))
def test_multikey_ragged_plain_matches_per_group(decrypt):
    """The ragged plain version against the uniform one (the JAX contract's,
    ctrw_fused_multikey_plain) run per key size on the group's messages
    zero-padded to its longest; cipher_blocks_ragged_dev (the batch
    engines' call) gives the same."""
    keys, lay, blocks = _ragged_case(2 + decrypt)
    got = mk.cipher_blocks_ragged(mk.layout_round_keys(keys, CPU), lay.desc,
                                  torch.from_numpy(blocks), decrypt).numpy()
    assert np.array_equal(got, tbulk.cipher_blocks_ragged_dev(
        keys, torch.from_numpy(blocks), NBLOCKS, decrypt).numpy())
    for klen in (16, 24, 32):
        idx = [i for i, k in enumerate(keys) if len(k) == klen]
        wm = mk.mk_window_words(max(NBLOCKS[i] for i in idx))
        buf = np.zeros((len(idx), 32 * wm, 16), np.uint8)
        for j, i in enumerate(idx):
            buf[j, :NBLOCKS[i]] = blocks[lay.offsets[i]:lay.offsets[i] + NBLOCKS[i]]
        kp = key_planes_batch(torch.from_numpy(stack_round_keys([keys[i] for i in idx])))
        words = torch.from_numpy(buf.reshape(-1, 512)).view(torch.int32).reshape(-1, 128)
        want = mk.ctrw_fused_multikey_plain(kp.reshape(-1, 1), words, torch.zeros_like(words),
                                            len(idx), decrypt)
        want = want.view(torch.uint8).reshape(len(idx), -1, 16).numpy()
        for j, i in enumerate(idx):
            assert np.array_equal(got[lay.offsets[i]:lay.offsets[i] + NBLOCKS[i]],
                                  want[j, :NBLOCKS[i]])
    assert mk.cipher_blocks_ragged.launches == 0  # no kernel on the CPU


@pytest.mark.parametrize("decrypt", (False, True), ids=("encrypt", "decrypt"))
def test_multikey_ragged_matches_jax(decrypt):
    """The ragged entry against the JAX package's cipher_blocks_multikey on
    the batch zero-padded to its longest message (it takes one block count
    for all)."""
    keys, lay, blocks = _ragged_case(4 + decrypt)
    got = mk.cipher_blocks_ragged(mk.layout_round_keys(keys, CPU), lay.desc,
                                  torch.from_numpy(blocks), decrypt).numpy()
    padded = np.zeros((len(keys), max(NBLOCKS), 16), np.uint8)
    for i, n in enumerate(NBLOCKS):
        padded[i, :n] = blocks[lay.offsets[i]:lay.offsets[i] + n]
    want = jbulk.cipher_blocks_multikey(keys, padded, decrypt)
    for i, n in enumerate(NBLOCKS):
        assert np.array_equal(got[lay.offsets[i]:lay.offsets[i] + n], want[i, :n])


def _aead_operands(seed, klen, b=32, nb=3):
    """test_torch_aead.py's twin shapes (B = 32, nb = 3), counter bases that
    carry into byte 9, nvalid from 0 to nb (SIV: from 1)."""
    rng = np.random.default_rng(seed)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))

    def lane_keys():
        return u32_tensor(key_planes_packed(stack_round_keys(
            [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)])), CPU)

    c0, init, tail, lastadd, prevadd, blocks = (u8(b, 16), u8(b, 16), u8(b, 16), u8(b, 16),
                                                u8(b, 16), u8(b, nb, 16))
    c0[0, 9:] = 0xFF
    c0[1, 12:] = 0xFF
    c0[2, 9:12] = 0xFF
    nv = rng.integers(0, nb + 1, b).astype(np.int32)
    nv[:2] = (0, nb)
    return (lane_keys(), lane_keys(), c0, init, tail, lastadd, prevadd, blocks,
            torch.from_numpy(nv))


@pytest.mark.parametrize("op", ("ccm", "ccm_open", "eax", "eax_open", "siv_seal", "siv_open"))
def test_aead_two_steps_match_monolithic(op):
    """Each of the six operations as its two steps (K15's keystream pass and
    K13's MAC with the last-step constants, on their plain versions) against
    the monolithic plain version, AES-128 and AES-256."""
    for klen in (16, 32):
        kpw, kpc, c0, init, tail, lastadd, prevadd, blocks, nvalid = _aead_operands(
            70 + klen + len(op), klen)
        if op.startswith("siv"):
            nvalid = nvalid.clamp(min=1)  # S2V folds at least one block
            if op == "siv_seal":
                args = (kpw, kpc, init, blocks, nvalid, tail, lastadd, prevadd)
                got, want = ak.siv_seal_chain_fused(*args), ak.siv_seal_chain_fused_plain(*args)
            else:
                args = (kpw, kpc, c0, init, blocks, nvalid, tail, lastadd, prevadd)
                got, want = ak.siv_open_chain_fused(*args), ak.siv_open_chain_fused_plain(*args)
        else:
            args = (op[:3], kpw, c0, init, blocks, nvalid, tail, lastadd, op.endswith("open"))
            got, want = ak.aead_chain_fused(*args), ak.aead_chain_fused_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ak.aead_chain_fused.launches == ak.ctr_packed_fused.launches == 0


def test_keystream_and_mac_options():
    """K15's whitener (E(c0), the payload from c0 + 1) and K13's MAC
    constants against their definitions: the plain keystream from the next
    counter, and the masked fold of the blocks with the constants applied; a
    call without constants is the plain masked fold."""
    kpw, _, c0, init, tail, lastadd, prevadd, blocks, nvalid = _aead_operands(90, 24)
    out, wh = ak.ctr_packed_fused(kpw, c0, blocks, whiten=True)
    from micro_aes_tpu_torch.ops.counter import ctr56_add

    nxt = ctr56_add(c0, torch.ones(c0.shape[0], dtype=torch.int64))
    assert torch.equal(out, ak.ctr_packed_fused(kpw, nxt, blocks))
    assert torch.equal(wh, ak.ctr_packed_fused(kpw, c0, torch.zeros_like(blocks[:, :1]))[:, 0])
    plain = ck.cbcmac_packed_fused(kpw, init, blocks, nvalid)
    assert torch.equal(plain, ck.cbcmac_packed_fused_plain(kpw, init, blocks, nvalid))
    full = ck.cbcmac_packed_fused(kpw, init, blocks, nvalid, tail, lastadd, prevadd)
    macin = ck.mac_input(blocks, nvalid, tail, lastadd, prevadd)
    assert torch.equal(full, ck.cbcmac_packed_fused(kpw, init, macin, nvalid))
    with pytest.raises(ValueError):
        ck.cbcmac_packed_fused(kpw, init, blocks, nvalid, tail=tail)
