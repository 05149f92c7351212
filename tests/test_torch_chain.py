"""Parity of the port's serial-chain layer with the JAX package, on the CPU:
the packed scans that are K13's plain versions (ops/chain_kernels, modes/
_scan), the CBC-MAC folds (ops/mac), the chain batches (modes/chain_bulk)
and the CMAC and XTS batches (modes/bulk).

Inputs come from numpy seeds and go through both packages with the same
key planes (chain_keys_from_jax); every output is bytes or an integer array
and every comparison is bit-exact.  The JAX packed scans run eagerly under
jax.disable_jit at B = 32 and nb <= 2 (an XLA compile of the bitsliced scan
costs seconds); its folds, per-message scans and batch engines run jitted on
a few shapes.  K13's Pallas form is never run (interpret mode costs minutes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes._scan as jscan
import micro_aes_tpu.modes.bulk as jbulk
import micro_aes_tpu.modes.chain_bulk as jcb
import micro_aes_tpu.ops.mac as jmac
from micro_aes_tpu.core.bitslice import key_planes_packed as j_key_planes_packed
from micro_aes_tpu.core.keyschedule import expand_key as j_expand_key
from micro_aes_tpu.modes.common import PAD_ISO7816, PAD_PKCS7, PAD_ZERO
from micro_aes_tpu.utils.bytesio import block_bucket as j_block_bucket

import micro_aes_tpu_torch.modes._scan as tscan
import micro_aes_tpu_torch.modes.bulk as tbulk
import micro_aes_tpu_torch.modes.chain_bulk as tcb
import micro_aes_tpu_torch.ops.mac as tmac
from micro_aes_tpu_torch import DataLengthError, DecryptionError
from micro_aes_tpu_torch.ops import chain_kernels as ck
from micro_aes_tpu_torch.utils.bytesio import block_bucket
from micro_aes_tpu_torch.utils.keycache import registered_key_caches

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _round_keys(rng, b, klen):
    """A stack of b random keys' round keys (the JAX key schedule)."""
    return np.stack([np.asarray(j_expand_key(_rand(rng, klen))) for _ in range(b)])


def _lane_keys(rng, b, klen):
    """Per-lane round keys and their packed planes (JAX's)."""
    rks = _round_keys(rng, b, klen)
    return rks, j_key_planes_packed(rks)


@pytest.mark.parametrize("kind,klen,nb", [("cbc", 16, 2), ("cfb", 16, 2), ("ofb", 16, 2),
                                          ("cbc", 32, 1)])
def test_packed_scans_match_jax(kind, klen, nb):
    """K13's plain versions (the packed scans) against the JAX package's
    packed scans, fed the same lane-packed key planes."""
    rng = np.random.default_rng(10 + nb + klen)
    _, kpw = _lane_keys(rng, 32, klen)
    ivs = rng.integers(0, 256, (32, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (32, nb, 16), dtype=np.uint8)
    with jax.disable_jit():
        if kind == "ofb":
            want = jscan.ofb_keystream_scan_packed(kpw, jnp.asarray(ivs), jnp.zeros(nb, jnp.uint8))
        else:
            fn = jscan.cbc_encrypt_scan_packed if kind == "cbc" else jscan.cfb_encrypt_scan_packed
            want = fn(kpw, jnp.asarray(ivs), jnp.asarray(blocks))
    kt = ck.chain_keys_from_jax(kpw, device=CPU)
    assert kt.dtype == torch.int32 and kt.shape == kpw.shape
    if kind == "ofb":
        got = ck.ofb_packed_fused(kt, _t(ivs), nb)
    else:
        got = ck.chain_packed_fused(kind, kt, _t(ivs), _t(blocks))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert ck.chain_packed_fused.launches == ck.ofb_packed_fused.launches == 0  # no kernel on the CPU


def test_cbcmac_packed_and_folds_match_jax():
    """K13's masked CBC-MAC (plain version), the byte-cipher folds and the
    per-message scans against the JAX folds and scans, with nvalid from 0 to
    nb."""
    rng = np.random.default_rng(20)
    nb = 3
    rks, kpw = _lane_keys(rng, 32, 16)
    init = rng.integers(0, 256, (32, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (32, nb, 16), dtype=np.uint8)
    nvalid = rng.integers(0, nb + 1, 32).astype(np.int32)
    nvalid[:2] = (0, nb)
    want = np.asarray(jmac.cbcmac_fold_batch(rks, init, blocks, nvalid))
    got = ck.cbcmac_packed_fused(ck.chain_keys_from_jax(kpw, device=CPU), _t(init), _t(blocks),
                                 _t(nvalid))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tmac.cbcmac_fold_batch(_t(rks), _t(init), _t(blocks), nvalid).numpy(),
                          want)
    for i in (0, 1, 2):
        one = jmac.cbcmac_fold(rks[i], init[i], blocks[i], jnp.int32(nvalid[i]))
        assert np.array_equal(tmac.cbcmac_fold(_t(rks[i]), _t(init[i]), _t(blocks[i]),
                                               int(nvalid[i])).numpy(), np.asarray(one))
    rk, iv, x = rks[3], init[3], blocks[3]
    for jfn, tfn in ((jscan.cbc_encrypt_scan, tscan.cbc_encrypt_scan),
                     (jscan.cfb_encrypt_scan, tscan.cfb_encrypt_scan)):
        assert np.array_equal(tfn(_t(rk), _t(iv), _t(x)).numpy(), np.asarray(jfn(rk, iv, x)))
    assert np.array_equal(tscan.ofb_keystream_scan(_t(rk), _t(iv), nb).numpy(),
                          np.asarray(jscan.ofb_keystream_scan(rk, iv, jnp.zeros((nb, 1)))))


@pytest.mark.parametrize("b", [5, 37])
def test_cbcmac_fold_batch_auto_matches_jax(b):
    """The batch engines' CBC-MAC (padded to 32 lanes, key planes cached)
    against the JAX fold, at batch sizes that are not a multiple of 32."""
    rng = np.random.default_rng(30 + b)
    rks = _round_keys(rng, b, 24)
    init = rng.integers(0, 256, (b, 16), dtype=np.uint8)
    blocks = rng.integers(0, 256, (b, 2, 16), dtype=np.uint8)
    nvalid = rng.integers(0, 3, b).astype(np.int32)
    want = np.asarray(jmac.cbcmac_fold_batch_auto(rks, init, blocks, nvalid))
    got = tmac.cbcmac_fold_batch_auto(rks, _t(init), _t(blocks), torch.from_numpy(nvalid))
    assert np.array_equal(got.numpy(), want)
    assert tmac._kpw_cached in registered_key_caches()


def _mk(rng, lens, keylens=(16, 24, 32)):
    keys = [_rand(rng, keylens[i % len(keylens)]) for i in range(len(lens))]
    return keys, [_rand(rng, 16) for _ in lens], [_rand(rng, n) for n in lens]


def test_block_bucket_matches_jax():
    for n in (0, 1, 2, 3, 5, 33, 256, 257):
        assert block_bucket(n) == j_block_bucket(max(n, 1))


def test_cbc_cts_batch_matches_jax():
    """CBC-CTS over mixed key sizes and lengths that steal, swap two whole
    blocks or are one block (the JAX side is compiled per block bucket and
    key size, so the lengths share buckets); the decrypt batch inverts it."""
    rng = np.random.default_rng(40)
    keys, ivs, pts = _mk(rng, [16, 17, 32, 20, 100], keylens=(16, 16, 16, 24, 24))
    out = tcb.cbc_encrypt_batch(keys, ivs, pts, device=CPU)
    assert out == jcb.cbc_encrypt_batch(keys, ivs, pts, cts=True)
    assert tcb.cbc_decrypt_batch(keys, ivs, out, device=CPU) == pts
    with pytest.raises(DataLengthError):
        tcb.cbc_encrypt_batch([bytes(16)], [bytes(16)], [b"short"], device=CPU)
    with pytest.raises(DataLengthError):
        tcb.cbc_decrypt_batch([bytes(16)], [bytes(16)], [bytes(20)], cts=False, device=CPU)


@pytest.mark.parametrize("padding", [PAD_ZERO, PAD_PKCS7, PAD_ISO7816])
def test_cbc_padded_batch_matches_jax(padding):
    rng = np.random.default_rng(41 + padding)
    keys, ivs, pts = _mk(rng, [0, 16, 21, 40], keylens=(16,))
    out = tcb.cbc_encrypt_batch(keys, ivs, pts, cts=False, padding=padding, device=CPU)
    assert out == jcb.cbc_encrypt_batch(keys, ivs, pts, cts=False, padding=padding)
    back = tcb.cbc_decrypt_batch(keys, ivs, out, cts=False, device=CPU)
    assert all(b[: len(p)] == p for b, p in zip(back, pts))


def test_cfb_ofb_batches_match_jax():
    """CFB and OFB with empty, one-byte, ragged and whole-block messages
    under two key sizes; CFB decrypt and OFB invert them."""
    rng = np.random.default_rng(43)
    keys, ivs, pts = _mk(rng, [0, 1, 15, 16, 33, 50], keylens=(16, 16, 16, 32, 32, 32))
    cfb = tcb.cfb_encrypt_batch(keys, ivs, pts, device=CPU)
    assert cfb == jcb.cfb_encrypt_batch(keys, ivs, pts)
    assert tcb.cfb_decrypt_batch(keys, ivs, cfb, device=CPU) == pts
    ofb = tcb.ofb_xcrypt_batch(keys, ivs, pts, device=CPU)
    assert ofb == jcb.ofb_xcrypt_batch(keys, ivs, pts)
    assert tcb.ofb_decrypt_batch(keys, ivs, ofb, device=CPU) == pts


def test_ecb_ctr_batches_match_jax():
    rng = np.random.default_rng(44)
    keys, ivs, pts = _mk(rng, [0, 5, 16, 40], keylens=(16, 16, 24, 24))
    ecb = tcb.ecb_encrypt_batch(keys, pts, padding=PAD_PKCS7, device=CPU)
    assert ecb == jcb.ecb_encrypt_batch(keys, pts, padding=PAD_PKCS7)
    back = tcb.ecb_decrypt_batch(keys, ecb, device=CPU)
    assert all(b[: len(p)] == p for b, p in zip(back, pts))
    with pytest.raises(DecryptionError):
        tcb.ecb_decrypt_batch(keys[:1], [bytes(17)], device=CPU)
    nonces = [iv[:12] for iv in ivs]
    ctr = tcb.ctr_xcrypt_batch(keys, nonces, pts, device=CPU)
    assert ctr == jcb.ctr_xcrypt_batch(keys, nonces, pts)
    assert tcb.ctr_decrypt_batch(keys, nonces, ctr, device=CPU) == pts
    wrap = [iv[:12] + b"\xff\xff\xff\xfe" for iv in ivs]  # the counter carries into byte 11
    assert (tcb.ctr_xcrypt_batch(keys, wrap, pts, preset_counter=True, device=CPU)
            == jcb.ctr_xcrypt_batch(keys, wrap, pts, preset_counter=True))


def test_cipher_blocks_multikey_both_directions():
    """K9 over mixed key sizes, against the JAX package encrypting; the
    decrypt direction inverts it, on host arrays and on tensors."""
    rng = np.random.default_rng(45)
    keys = [_rand(rng, (16, 24, 32)[i % 3]) for i in range(5)]
    blocks = rng.integers(0, 256, (5, 3, 16), dtype=np.uint8)
    enc = tbulk.cipher_blocks_multikey(keys, blocks, device=CPU)
    assert np.array_equal(enc, jbulk.cipher_blocks_multikey(keys, blocks))
    assert np.array_equal(tbulk.cipher_blocks_multikey(keys, enc, True, device=CPU), blocks)
    assert np.array_equal(tbulk.cipher_blocks_multikey_dev(keys, _t(enc), True).numpy(), blocks)


def test_cmac_and_xts_batches_match_jax():
    """cmac_batch over mixed key sizes and lengths 0..50 (K13's CBC-MAC),
    and xts_batch (K9) against JAX encrypting, decrypting back."""
    rng = np.random.default_rng(46)
    keys, _, msgs = _mk(rng, [0, 1, 16, 17, 32, 50], keylens=(16, 16, 16, 32, 32, 32))
    assert tbulk.cmac_batch(keys, msgs, device=CPU) == jbulk.cmac_batch(keys, msgs)
    xkeys = [_rand(rng, (32, 64)[i % 2]) for i in range(4)]
    tweaks = [_rand(rng, 16) for _ in xkeys]
    datas = [_rand(rng, 48) for _ in xkeys]
    ct = tbulk.xts_batch(xkeys, tweaks, datas, True, device=CPU)
    assert ct == jbulk.xts_batch(xkeys, tweaks, datas, True)
    assert tbulk.xts_batch(xkeys, tweaks, ct, False, device=CPU) == datas


def test_xts_batch_rejects_messages_that_are_not_n_whole_blocks():
    """xts_batch takes n from the first message; a message of another
    length, or one that is not whole blocks, raises DataLengthError (the
    JAX batch crashes in numpy's reshape there, so it is not called)."""
    rng = np.random.default_rng(47)
    for lens in ((48, 32), (48, 49), (17,), (0, 16)):
        keys = [_rand(rng, 32) for _ in lens]
        tweaks = [_rand(rng, 16) for _ in lens]
        datas = [_rand(rng, n) for n in lens]
        for encrypt in (True, False):
            with pytest.raises(DataLengthError):
                tbulk.xts_batch(keys, tweaks, datas, encrypt, device=CPU)
