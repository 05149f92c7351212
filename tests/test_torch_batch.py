"""Parity of the port's multi-key batch AES-GCM (micro_aes_tpu_torch
modes/seal_batch, modes/bulk, ops/chain, ops/multikey) with the JAX
package, on the CPU, where the K9 and K10 wrappers run their plain
versions.

The value-chain engine is driven with the port's lane target monkeypatched
(as tests/test_gcm_chain.py does for the JAX engine) so that small batches
still split into segments, and every message is held against the JAX
package's per-message gcm_encrypt.  The K10 plain version is held against
the JAX kernel itself, run in interpret mode at its smallest shape (32
lanes, 2 steps, AES-128: about 30 s on a CPU).  Bit-exact
throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.seal_batch as jsb
from micro_aes_tpu.core.bitslice import key_planes, key_planes_packed
from micro_aes_tpu.modes.bulk import stack_round_keys as j_stack_round_keys
from micro_aes_tpu.modes.gcm import gcm_encrypt as j_gcm_encrypt
from micro_aes_tpu.ops.pallas_chain import gcm_chain_fused_raw as j_gcm_chain_fused_raw
from micro_aes_tpu.ops.pallas_chain import ghash_halving_table as j_ghash_halving_table
from micro_aes_tpu.ops.pallas_multikey import ctrw_fused_multikey_jnp, mk_key_stack
from micro_aes_tpu.ops.pallas_multikey import mk_window_words as j_mk_window_words

import micro_aes_tpu_torch.modes.seal_batch as tsb
from micro_aes_tpu_torch.core.cipher import encrypt_blocks_np
from micro_aes_tpu_torch.ops.chain import (
    gcm_chain_fused,
    gcm_chain_fused_plain,
    ghash_halving_table,
)
from micro_aes_tpu_torch.ops.mac import ghash_fold_batch, halving_table, mul_by_table
from micro_aes_tpu_torch.ops.multikey import ctrw_fused_multikey, mk_window_words
from micro_aes_tpu_torch.utils.bytesio import u32_tensor

CPU = "cpu"


def _rand(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _u8(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8))


def test_mk_window_words_matches_jax():
    for n in list(range(0, 300)) + [1025, 8193, 17000, 17153, 65537]:
        assert mk_window_words(n) == j_mk_window_words(n), n


@pytest.mark.parametrize("klen,decrypt", [(16, False), (32, True)],
                         ids=("aes128_encrypt", "aes256_decrypt"))
def test_multikey_plain_matches_jax(klen, decrypt):
    rng = np.random.default_rng(klen + decrypt)
    b, wm = 3, 8
    keys = [_rand(rng, klen).tobytes() for _ in range(b)]
    kp_stack = np.asarray(mk_key_stack([jnp.asarray(key_planes(r))
                                        for r in j_stack_round_keys(keys)]))
    ctr = rng.integers(0, 2**32, (b * wm, 128), dtype=np.uint32)
    pt = rng.integers(0, 2**32, (b * wm, 128), dtype=np.uint32)
    want = ctrw_fused_multikey_jnp(jnp.asarray(kp_stack), jnp.asarray(ctr), jnp.asarray(pt),
                                   b, decrypt=decrypt)
    got = ctrw_fused_multikey(u32_tensor(kp_stack, CPU), u32_tensor(ctr, CPU),
                              u32_tensor(pt, CPU), b, decrypt)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_halving_table_matches_jax():
    h = _rand(np.random.default_rng(4), 64, 16)
    np.testing.assert_array_equal(ghash_halving_table(_u8(h)).numpy().view(np.uint32),
                                  np.asarray(j_ghash_halving_table(jnp.asarray(h))))


def test_chain_plain_matches_jax_kernel_interpret():
    """One case at the smallest shape: 32 lanes, 2 steps, AES-128, sealing,
    every mask random (freeze, source, last block and injection all
    mixed).  About 30 s on a CPU, nearly all of it the JAX kernel."""
    rng = np.random.default_rng(5)
    lanes, nb = 32, 2
    rks = j_stack_round_keys([_rand(rng, 16).tobytes() for _ in range(lanes)])
    kpw = key_planes_packed(rks)
    htab = np.asarray(j_ghash_halving_table(jnp.asarray(_rand(rng, lanes, 16))))
    c0 = _rand(rng, lanes, 16)
    c0[:, 12:16] = 0xFF  # the low word wraps into bytes 9..11 on step 1
    u8s = [_rand(rng, lanes, 16) for _ in range(3)]  # init, tail, initadd
    blocks = _rand(rng, lanes, nb, 16)
    m = [rng.integers(0, 2**32, (nb, 1), dtype=np.uint32) for _ in range(4)]
    want = j_gcm_chain_fused_raw(
        jnp.asarray(kpw), jnp.asarray(htab), jnp.asarray(c0), jnp.asarray(u8s[0]),
        jnp.asarray(blocks), *map(jnp.asarray, m), jnp.asarray(u8s[1]), jnp.asarray(u8s[2]))
    got = gcm_chain_fused_plain(
        u32_tensor(kpw, CPU), u32_tensor(htab, CPU), _u8(c0), _u8(u8s[0]), _u8(blocks),
        *(u32_tensor(x, CPU) for x in m), _u8(u8s[1]), _u8(u8s[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_natural_chain_wrapper_is_gcm():
    """gcm_chain_fused (messages from step 0, carry frozen after the last
    block) with the GCM counter base and the AAD fold as init gives the
    ciphertext and, after the length block, the tag of gcm_encrypt."""
    rng = np.random.default_rng(6)
    lanes = 32
    keys = [_rand(rng, 24).tobytes() for _ in range(lanes)]
    nonces = [_rand(rng, 12).tobytes() for _ in range(lanes)]
    lens = [int(x) for x in rng.integers(0, 70, lanes)]
    aads = [_rand(rng, i % 21).tobytes() for i in range(lanes)]
    pts = [_rand(rng, n).tobytes() for n in lens]
    nb = -(-max(lens) // 16)
    rks = j_stack_round_keys(keys)
    h = np.stack([encrypt_blocks_np(k, np.zeros((1, 16), np.uint8))[0] for k in keys])
    j0 = np.zeros((lanes, 16), np.uint8)
    j0[:, :12] = np.frombuffer(b"".join(nonces), np.uint8).reshape(lanes, 12)
    c0 = j0.copy()
    j0[:, 15], c0[:, 15] = 1, 2
    blocks = np.zeros((lanes, nb * 16), np.uint8)
    tail = np.zeros((lanes, 16), np.uint8)
    aadb = np.zeros((lanes, 2 * 16), np.uint8)
    lenb = np.zeros((lanes, 16), np.uint8)
    for i, (p, a) in enumerate(zip(pts, aads)):
        blocks[i, : len(p)] = np.frombuffer(p, np.uint8)
        tail[i, : (len(p) - 1) % 16 + 1] = 0xFF
        aadb[i, : len(a)] = np.frombuffer(a, np.uint8)
        lenb[i] = np.frombuffer((8 * len(a)).to_bytes(8, "big") + (8 * len(p)).to_bytes(8, "big"),
                                np.uint8)
    init = ghash_fold_batch(_u8(h), torch.zeros((lanes, 16), dtype=torch.uint8),
                            _u8(aadb.reshape(lanes, 2, 16)), [-(-len(a) // 16) for a in aads])
    out, g = gcm_chain_fused(u32_tensor(key_planes_packed(rks), CPU), ghash_halving_table(_u8(h)),
                             _u8(c0), init, _u8(blocks.reshape(lanes, nb, 16)),
                             torch.tensor([-(-n // 16) for n in lens]), _u8(tail))
    tags = mul_by_table(g ^ _u8(lenb), halving_table(_u8(h))).numpy()
    ej0 = np.stack([encrypt_blocks_np(k, j0[i:i + 1])[0] for i, k in enumerate(keys)])
    for i in range(lanes):
        ct = out[i].reshape(-1)[: lens[i]].numpy().tobytes()
        assert ct + (tags[i] ^ ej0[i]).tobytes() == j_gcm_encrypt(keys[i], nonces[i], aads[i],
                                                                  pts[i]), i


def _batch(rng, lens, klen):
    b = len(lens)
    keys = [_rand(rng, klen).tobytes() for _ in range(b)]
    nonces = [_rand(rng, 12).tobytes() for _ in range(b)]
    aads = [_rand(rng, (7 * i) % 29).tobytes() for i in range(b)]
    pts = [_rand(rng, n).tobytes() for n in lens]
    return keys, nonces, aads, pts


def _drive(monkeypatch, lanes_target, lens, klen, seed):
    """The cases of tests/test_gcm_chain.py, through the port's engine."""
    monkeypatch.setattr(tsb, "_CHAIN_LANES", lanes_target)
    keys, nonces, aads, pts = _batch(np.random.default_rng(seed), lens, klen)
    got = tsb.gcm_seal_batch(keys, nonces, aads, pts, device=CPU)
    for i in range(len(lens)):
        assert got[i] == j_gcm_encrypt(keys[i], nonces[i], aads[i], pts[i]), lens[i]
    assert tsb.gcm_open_batch(keys, nonces, aads, got, device=CPU) == pts
    bad = [got[0][:-1] + bytes([got[0][-1] ^ 1])] + list(got[1:])
    back = tsb.gcm_open_batch(keys, nonces, aads, bad, device=CPU)
    assert back[0] is None and back[1:] == pts[1:]


@pytest.mark.parametrize("lanes_target,lens,seed", [
    (4096, [0, 16, 48, 160, 320], 7),   # S = nb: one block per segment
    (1, [64, 32], 8),                   # S = 1: no split
], ids=("s_eq_nb", "s_eq_1"))
def test_chain_unsegmented(monkeypatch, lanes_target, lens, seed):
    _drive(monkeypatch, lanes_target, lens, 16, seed)


@pytest.mark.parametrize("lens,seed", [
    ([96, 64, 16, 112], 9),
    ([0, 128, 0, 64, 16], 10),          # empty messages: AAD via the length multiply
], ids=("l_gt_1", "with_empty"))
def test_chain_segmented_l_gt_1(monkeypatch, lens, seed):
    _drive(monkeypatch, 8, lens, 16, seed)


def test_chain_aes256_batch_padding(monkeypatch):
    """3 messages in 3 segments each: padded to 32 messages (96 lanes)."""
    monkeypatch.setattr(tsb, "_CHAIN_LANES", 8)
    assert tsb._chain_shape(3, 5) == (32, 3, 2)
    _drive(monkeypatch, 8, [80, 80, 80], 32, 11)


def test_chain_state_from_jax(monkeypatch):
    """The JAX engine's per-key-set state equals the port's, and the port's
    engine run on the JAX state seals like gcm_encrypt."""
    monkeypatch.setattr(tsb, "_CHAIN_LANES", 8)
    keys, nonces, aads, pts = _batch(np.random.default_rng(12), [96, 48, 32], 16)
    bp, s, l = tsb._chain_shape(len(keys), 6)
    blob = b"".join(keys + [keys[-1]] * (bp - len(keys)))
    jstate = [np.asarray(x) for x in jsb._chain_cached(blob, 16, s, l)]
    state = tsb.chain_state_from_jax(*jstate, device=CPU)
    own = tsb._chain_cached(blob, 16, s, l, torch.device(CPU))
    for mine, theirs in zip(own, state):
        assert torch.equal(mine, theirs)
    monkeypatch.setattr(tsb, "_chain_cached", lambda *args: state)
    got = tsb.gcm_seal_batch(keys, nonces, aads, pts, device=CPU)
    for i in range(len(keys)):
        assert got[i] == j_gcm_encrypt(keys[i], nonces[i], aads[i], pts[i])


def test_ragged_fallback_mixed_keys():
    """Mixed key sizes, 8/60/12-byte nonces and partial blocks take the
    ragged engine (K9's plain version here)."""
    rng = np.random.default_rng(13)
    klens, nlens, plens = (16, 24, 32, 16, 24), (8, 60, 12, 12, 12), (0, 17, 100, 33, 2048)
    keys = [_rand(rng, k).tobytes() for k in klens]
    nonces = [_rand(rng, n).tobytes() for n in nlens]
    aads = [_rand(rng, (5 * i) % 23).tobytes() for i in range(len(klens))]
    pts = [_rand(rng, n).tobytes() for n in plens]
    for tag_len in (16, 12):
        got = tsb.gcm_seal_batch(keys, nonces, aads, pts, tag_len, device=CPU)
        for i in range(len(keys)):
            assert got[i] == j_gcm_encrypt(keys[i], nonces[i], aads[i], pts[i], tag_len), i
        assert tsb.gcm_open_batch(keys, nonces, aads, got, tag_len, device=CPU) == pts
        bad = list(got)
        bad[2] = bytes([bad[2][0] ^ 1]) + bad[2][1:]
        back = tsb.gcm_open_batch(keys, nonces, aads, bad, tag_len, device=CPU)
        assert back[2] is None and back[:2] + back[3:] == pts[:2] + pts[3:]
