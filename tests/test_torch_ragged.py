"""The ragged lane-spread entries of the port, on the CPU: the word layout of
ops/ragged (sort order, pairing of words in a warp, padding), the ragged key
planes, the plain versions of K13's chain_packed_ragged and K16's
kw_wheel_ragged against the per-group plain versions, and the one-launch
batches (modes/bulk KW, modes/chain_bulk CBC/CFB/OFB) against the JAX
package.

Inputs come from numpy seeds; every comparison is bit-exact.  The JAX
batches run jitted on a few tiny shapes (one compile per group shape).
"""
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.bulk as jbulk
import micro_aes_tpu.modes.chain_bulk as jcb

import micro_aes_tpu_torch.modes.bulk as tbulk
import micro_aes_tpu_torch.modes.chain_bulk as tcb
from micro_aes_tpu_torch.core.bitslice import key_planes_packed
from micro_aes_tpu_torch.ops import chain_kernels as ck
from micro_aes_tpu_torch.ops import kw_kernels as kk
from micro_aes_tpu_torch.ops.ragged import (
    check_desc,
    layout_key_planes,
    ragged_key_planes,
    ragged_layout,
    round_keys15,
)
from micro_aes_tpu_torch.utils.keycache import registered_key_caches

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_ragged_layout_pins_order_pairing_and_padding():
    """Longest first, then more rounds first, then batch order; 32 to a
    word; a run with an odd number of words gets an idle word that shares
    its steps and rounds; messages without a step are left out."""
    steps = [3, 5, 3, 5, 0, 3]
    rounds = [10, 10, 14, 10, 10, 10]
    lay = ragged_layout(steps, rounds, [16 * s for s in steps])
    assert lay.order.tolist() == [1, 3, 2, 0, 5]
    assert lay.offsets.tolist() == [0, 80, 160, 208, 256]
    assert lay.nbytes == 304
    assert lay.word.tolist() == [0, 0, 2, 4, 4] and lay.slot.tolist() == [0, 1, 0, 0, 1]
    assert lay.desc.tolist() == [
        [5, 10 | 2 << 8, 0, 0], [5, 10, 0, 0],      # two live slots, then the idle word
        [3, 14 | 1 << 8, 2, 160], [3, 14, 0, 0],
        [3, 10 | 2 << 8, 3, 208], [3, 10, 0, 0],
    ]
    # 33 messages of one shape fill two words (32 and 1), so no idle word;
    # 65 take three words and an idle one
    lay = ragged_layout([2] * 33 + [4] * 65, [12] * 98, [8 * 3] * 33 + [8 * 5] * 65)
    assert lay.order.tolist() == list(range(33, 98)) + list(range(33))
    live = (lay.desc[:, 1] >> 8).tolist()
    assert lay.desc[:, 0].tolist() == [4] * 4 + [2] * 2
    assert live == [32, 32, 1, 0, 32, 1]
    assert lay.desc[:, 2].tolist() == [0, 32, 64, 0, 65, 97]
    assert lay.desc[4, 3] == 65 * 40 and lay.desc[5, 3] == 65 * 40 + 32 * 24
    check_desc("test", lay.desc, 98, lay.nbytes, lambda n: 8 * (n + 1))
    assert ragged_layout([0, 0], [10, 10], [0, 0]).desc.shape == (0, 4)


def test_check_desc_refuses_bad_descriptors():
    lay = ragged_layout([3, 5], [10, 10], [48, 80])
    with pytest.raises(ValueError, match="differ"):
        check_desc("t", lay.desc[[0, 3]], 2, lay.nbytes, lambda s: 16 * s)
    with pytest.raises(ValueError, match="outside"):
        check_desc("t", lay.desc, 2, lay.nbytes - 1, lambda s: 16 * s)
    bad = lay.desc.copy()
    bad[0, 1] = 11 | 1 << 8
    with pytest.raises(ValueError, match="rounds"):
        check_desc("t", bad, 2, lay.nbytes, lambda s: 16 * s)


def test_ragged_key_planes_match_key_planes_packed():
    """The planes built per live slot equal key_planes_packed of the dense
    slot array (idle slots zero, round keys padded to 15)."""
    rng = np.random.default_rng(7)
    keys = [_rand(rng, (16, 24, 32)[i % 3]) for i in range(45)]
    steps = rng.integers(1, 4, 45)
    lay = ragged_layout(steps, [len(k) // 4 + 6 for k in keys], 16 * steps)
    rks = round_keys15(keys)
    assert not rks[0, 11:].any() and rks[2, 14].any()
    dense = np.zeros((32 * lay.desc.shape[0], 15, 16), np.uint8)
    dense[32 * lay.word + lay.slot] = rks[lay.order]
    got = ragged_key_planes(rks[lay.order], lay.word, lay.slot, lay.desc.shape[0], CPU)
    assert np.array_equal(got.numpy().view(np.uint32), key_planes_packed(dense))
    cached = layout_key_planes(keys, lay, CPU)  # the cached form, registered for purging
    assert torch.equal(cached, got) and layout_key_planes(keys, lay, CPU) is cached
    assert any(c.cache_info().currsize for c in registered_key_caches())


def _kw_rows(rng, keks, ns, unwrap):
    rows = [np.frombuffer(_rand(rng, 8 * (n + 1)), np.uint8).copy() for n in ns]
    if not unwrap:
        for r in rows:
            r[:8] = 0
    return rows


@pytest.mark.parametrize("unwrap", (False, True))
def test_kw_ragged_plain_matches_per_group(unwrap):
    """kw_wheel_ragged's plain version (mixed n = 2, 3 and 7, KEKs of
    16/24/32 bytes, an odd number of words in a run) equals kw_packed's plain
    version run per (n, key size) group."""
    rng = np.random.default_rng(11 + unwrap)
    keks = [_rand(rng, (16, 24, 32)[i % 3]) for i in range(75)]
    ns = [(2, 3, 7)[(i // 3) % 3] for i in range(75)]
    ns[:33] = [3] * 33  # AES-128/192/256 x n = 3: an 11-message run, one word
    rows = _kw_rows(rng, keks, ns, unwrap)
    lay = ragged_layout(ns, [len(k) // 4 + 6 for k in keks], [len(r) for r in rows])
    assert (lay.desc[:, 1] >> 8 == 0).any()  # an idle word pads a run
    kpw = layout_key_planes(keks, lay, CPU)
    data = torch.from_numpy(np.concatenate([rows[i] for i in lay.order]))
    got = kk.kw_wheel_ragged(kpw, lay.desc, data, unwrap).numpy()
    for n, klen in {(n, len(k)) for n, k in zip(ns, keks)}:
        idx = [i for i in range(75) if ns[i] == n and len(keks[i]) == klen]
        pad = (-len(idx)) % 32
        rks = np.concatenate([tbulk.stack_round_keys([keks[i] for i in idx]),
                              np.zeros((pad, klen // 4 + 7, 16), np.uint8)])
        x = np.stack([rows[i].reshape(-1, 8) for i in idx] + [np.zeros((n + 1, 8), np.uint8)] * pad)
        want = kk.kw_packed_plain(torch.from_numpy(key_planes_packed(rks).view(np.int32)),
                                  torch.from_numpy(x if unwrap else x[:, 1:].copy()), unwrap)
        for k, i in enumerate(idx):
            pos = int(np.flatnonzero(lay.order == i)[0])
            off = lay.offsets[pos]
            assert np.array_equal(got[off:off + len(rows[i])], want[k].numpy().reshape(-1))


@pytest.mark.parametrize("kind", ("cbc", "cfb", "ofb"))
def test_chain_ragged_plain_matches_per_group(kind):
    """chain_packed_ragged's plain version (mixed block counts, key sizes,
    an odd word count) equals K13's plain version run per (blocks, key size)
    group."""
    rng = np.random.default_rng(21)
    keys = [_rand(rng, (16, 24, 32)[i % 3]) for i in range(70)]
    steps = [int(x) for x in rng.integers(1, 5, 70)]
    ivs = np.stack([np.frombuffer(_rand(rng, 16), np.uint8) for _ in keys])
    blocks = [np.frombuffer(_rand(rng, 16 * s), np.uint8) for s in steps]
    lay = ragged_layout(steps, [len(k) // 4 + 6 for k in keys], [16 * s for s in steps])
    kpw = layout_key_planes(keys, lay, CPU)
    iv_t = torch.from_numpy(ivs[lay.order])
    if kind == "ofb":
        got = ck.chain_packed_ragged("ofb", kpw, lay.desc, iv_t, nbytes=lay.nbytes)
    else:
        got = ck.chain_packed_ragged(kind, kpw, lay.desc, iv_t,
                                     torch.from_numpy(np.concatenate([blocks[i] for i in lay.order])))
    got = got.numpy()
    for s, klen in {(s, len(k)) for s, k in zip(steps, keys)}:
        idx = [i for i in range(70) if steps[i] == s and len(keys[i]) == klen]
        pad = (-len(idx)) % 32
        rks = np.concatenate([tbulk.stack_round_keys([keys[i] for i in idx]),
                              np.zeros((pad, klen // 4 + 7, 16), np.uint8)])
        kp = torch.from_numpy(key_planes_packed(rks).view(np.int32))
        iv = torch.from_numpy(np.concatenate([ivs[idx], np.zeros((pad, 16), np.uint8)]))
        if kind == "ofb":
            want = ck.ofb_packed_fused_plain(kp, iv, s)
        else:
            x = np.stack([blocks[i].reshape(s, 16) for i in idx] + [np.zeros((s, 16), np.uint8)] * pad)
            want = ck.chain_packed_fused_plain(kind, kp, iv, torch.from_numpy(x))
        for k, i in enumerate(idx):
            off = lay.offsets[int(np.flatnonzero(lay.order == i)[0])]
            assert np.array_equal(got[off:off + 16 * s], want[k].numpy().reshape(-1))


def test_kw_ragged_batches_match_jax():
    """The one-launch KW batches on a ragged batch (two (n, key size)
    groups) against the JAX package's key_wrap_batch/key_unwrap_batch, with
    a tampered member."""
    rng = np.random.default_rng(31)
    keks = [_rand(rng, 16) for _ in range(5)] + [_rand(rng, 32) for _ in range(3)]
    secrets = [_rand(rng, 16) for _ in range(5)] + [_rand(rng, 24) for _ in range(3)]
    want = jbulk.key_wrap_batch(keks, secrets)
    got = tbulk.key_wrap_batch(keks, secrets, device=CPU)
    assert got == want
    got[6] = bytes([got[6][0] ^ 2]) + got[6][1:]
    back = tbulk.key_unwrap_batch(keks, got, device=CPU)
    assert back == jbulk.key_unwrap_batch(keks, got)
    assert back[6] is None and back[:6] == secrets[:6]


def test_chain_ragged_batches_match_jax():
    """CBC, CFB and OFB encrypt over messages of 1-3 blocks under 16- and
    32-byte keys, one launch each, against the JAX package's batches."""
    rng = np.random.default_rng(41)
    lens = [16, 40, 33, 16, 48, 20]
    keys = [_rand(rng, (16, 32)[i % 2]) for i in range(len(lens))]
    ivs = [_rand(rng, 16) for _ in lens]
    pts = [_rand(rng, n) for n in lens]
    assert tcb.cbc_encrypt_batch(keys, ivs, pts, device=CPU) == jcb.cbc_encrypt_batch(
        keys, ivs, pts, cts=True)
    assert tcb.cfb_encrypt_batch(keys, ivs, pts, device=CPU) == jcb.cfb_encrypt_batch(keys, ivs, pts)
    assert tcb.ofb_xcrypt_batch(keys, ivs, pts, device=CPU) == jcb.ofb_xcrypt_batch(keys, ivs, pts)


@pytest.mark.parametrize("call", ("key_wrap_batch", "key_unwrap_batch", "cbc_encrypt_batch",
                                  "cfb_encrypt_batch", "ofb_xcrypt_batch"))
def test_ragged_batches_take_an_empty_batch(call):
    """An empty batch gives an empty list, as the repo's other batch APIs
    do, and launches nothing."""
    kw = call.startswith("key")
    fn = getattr(tbulk if kw else tcb, call)
    assert fn(*([], []) if kw else ([], [], []), device=CPU) == []
