"""Parity of the port's AES-GCM-SIV (micro_aes_tpu_torch: ops/gf128
polyval_matrix, the LE32 counter, modes/gcm_siv, the K4/K5 plain versions
of ops/siv_kernels and modes/siv_seal) with the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; every output is
an integer array or bytes and every comparison is bit-exact.  The JAX
kernel twins and stream functions run eagerly under jax.disable_jit (an
XLA compile of the stream pipeline costs seconds per shape); the JAX
per-message path runs jitted on a few shape buckets.  Shapes stay at one
stream width, W = 32 words (up to 1023 blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.siv_seal as jsiv
import micro_aes_tpu.ops.pallas_seal as jps
from micro_aes_tpu.modes.common import ctr_xcrypt as j_ctr_xcrypt
from micro_aes_tpu.modes.gcm_siv import gcm_siv_encrypt as j_gcm_siv_encrypt
from micro_aes_tpu.modes.seal import host_stream as j_host_stream
from micro_aes_tpu.ops import gf128 as jgf
from micro_aes_tpu.ops.counter import counter_blocks as j_counter_blocks

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.siv_seal as tsiv
from micro_aes_tpu_torch import AuthenticationError, DataLengthError
from micro_aes_tpu_torch.modes.common import ctr_xcrypt
from micro_aes_tpu_torch.core.bitslice import key_planes
from micro_aes_tpu_torch.core.keyschedule import expand_key
from micro_aes_tpu_torch.modes.seal import host_stream, position_mask
from micro_aes_tpu_torch.ops import gf128 as tgf
from micro_aes_tpu_torch.ops import siv_kernels
from micro_aes_tpu_torch.ops.counter import counter_blocks
from micro_aes_tpu_torch.testing.kat import GCM_SIV_VECTORS

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _setups(klen, seed):
    """One (key, nonce) set up by the JAX package and carried across."""
    rng = np.random.default_rng(seed)
    key, nonce = _rand(rng, klen), _rand(rng, 12)
    jsetup = jsiv._siv_key_setup(key, nonce)
    np_setup = (jsetup[0], np.asarray(jsetup[1]),
                jax.tree_util.tree_map(np.asarray, jsetup[2]))
    return key, nonce, jsetup, tsiv.siv_key_setup_from_jax(*np_setup, device=CPU)


@pytest.mark.parametrize("seed", [0, 1])
def test_polyval_matrix_matches_jax(seed):
    h = np.random.default_rng(seed).integers(0, 256, 16, dtype=np.uint8)
    assert np.array_equal(tgf.polyval_matrix(h), jgf.polyval_matrix(h))
    x = np.random.default_rng(seed + 10).integers(0, 256, (5, 16), dtype=np.uint8)
    assert np.array_equal(tgf._halve_le_np(x), jgf._halve_le_np(x))


@pytest.mark.parametrize("word0", [0xFFFFFFF0, 0x00000000, 0x7FFFFFFF])
def test_le32_counter_blocks_match_jax_across_a_wrap(word0):
    base = np.random.default_rng(word0 & 0xFF).integers(0, 256, 16, dtype=np.uint8)
    base[:4] = np.frombuffer(word0.to_bytes(4, "little"), np.uint8)
    got = counter_blocks(torch.from_numpy(base), 40, 3, endian="le32")
    want = j_counter_blocks(jnp.asarray(base), 40, 3, "le32")
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("vector", GCM_SIV_VECTORS, ids=lambda v: v[0])
def test_gcm_siv_vectors(vector):
    name, key, nonce, aad, pt, blob = vector
    assert j_gcm_siv_encrypt(key, nonce, aad, pt) == blob  # the copy matches JAX's
    assert aes.gcm_siv_encrypt(key, nonce, aad, pt, device=CPU) == blob
    assert aes.gcm_siv_decrypt(key, nonce, aad, blob, device=CPU) == pt
    bad = bytearray(blob)
    bad[-1] ^= 0x20
    with pytest.raises(AuthenticationError):
        aes.gcm_siv_decrypt(key, nonce, aad, bytes(bad), device=CPU)


@pytest.mark.parametrize("klen,aad_len,pt_len", [(16, 0, 16), (32, 13, 500), (16, 31, 1000)])
def test_gcm_siv_per_message_matches_jax(klen, aad_len, pt_len):
    """AAD and a partial tail, AES-128/256."""
    rng = np.random.default_rng(klen + pt_len)
    key, nonce, aad, pt = _rand(rng, klen), _rand(rng, 12), _rand(rng, aad_len), _rand(rng, pt_len)
    blob = aes.gcm_siv_encrypt(key, nonce, aad, pt, device=CPU)
    assert blob == j_gcm_siv_encrypt(key, nonce, aad, pt)
    assert aes.gcm_siv_decrypt(key, nonce, aad, blob, device=CPU) == pt
    bad = bytearray(blob)
    bad[0] ^= 1
    with pytest.raises(AuthenticationError):
        aes.gcm_siv_decrypt(key, nonce, aad, bytes(bad), device=CPU)


def test_nonce_length_and_bulk_shape_checks():
    key = bytes(16)
    for fn, args in ((aes.gcm_siv_encrypt, (b"", b"")), (aes.gcm_siv_decrypt, (b"", bytes(16))),
                     (aes.gcm_siv_seal, (bytes(16),)), (aes.gcm_siv_open, (bytes(32),))):
        with pytest.raises(DataLengthError):
            fn(key, bytes(8), *args, device=CPU)
    with pytest.raises(ValueError):
        aes.gcm_siv_seal(key, bytes(12), bytes(17), device=CPU)  # not whole blocks


@pytest.mark.parametrize("klen", (16, 32))
def test_siv_kernel_plain_versions_match_jax_twins(klen):
    """K4, K5 and K5-open plain versions vs ghash1_fused_jnp,
    siv_ctrw_fused_jnp and siv_open_fused_jnp at W = 32: a random base in
    every lane, then a base whose word 0 wraps mid-stream."""
    _, _, (_, jkp, jtables, jw1t), (_, kp, tables) = _setups(klen, 40 + klen)
    rng = np.random.default_rng(klen)
    w = 32
    kpf = np.asarray(jkp).reshape(-1, 1)
    ghm = rng.integers(0, 2**32, (1, w), dtype=np.uint32)
    x = rng.integers(0, 2**32, (w, 128), dtype=np.uint32)
    basew = rng.integers(0, 2**32, (1, 128), dtype=np.uint32)
    wrap = basew.copy()
    wrap[0, 0::4] = 2**32 - 32 * 11 - 5  # wraps inside row 10
    with jax.disable_jit():
        js1 = jps.ghash1_fused_jnp(jnp.asarray(ghm), jw1t, jnp.asarray(x))
        jct = [jps.siv_ctrw_fused_jnp(jnp.asarray(kpf), jnp.asarray(b), jnp.asarray(x))
               for b in (basew, wrap)]
        jopen = jps.siv_open_fused_jnp(jnp.asarray(kpf), jnp.asarray(wrap), jnp.asarray(ghm),
                                       jw1t, jnp.asarray(x))
    ts1 = siv_kernels.ghash1_fused(_i32(ghm), tables[5], _i32(x))
    assert ts1.dtype == torch.int8 and np.array_equal(ts1.numpy(), np.asarray(js1))
    for b, want in zip((basew, wrap), jct):
        got = siv_kernels.siv_ctrw_fused(kp.reshape(-1, 1), _i32(b), _i32(x))
        assert np.array_equal(_u32(got), np.asarray(want))
    got = siv_kernels.siv_open_fused(kp.reshape(-1, 1), _i32(wrap), _i32(ghm), tables[5], _i32(x))
    assert np.array_equal(_u32(got[0]), np.asarray(jopen[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(jopen[1]))
    # the transposed wrappers on the CPU: K4 behind a transpose, and K5t's
    # plain version (see test_k5t_transposed_matches_jax_twin)
    got_t = siv_kernels.ghash1_fused_t(_i32(ghm), tables[5], _i32(x.T))
    assert np.array_equal(got_t.numpy(), np.asarray(js1))
    got_t = siv_kernels.siv_ctrw_fused_t(kp.reshape(-1, 1), _i32(basew), _i32(x.T))
    assert np.array_equal(_u32(got_t), np.asarray(jct[0]).T)


@pytest.mark.parametrize("klen", (16, 24, 32))
def test_k5t_transposed_matches_jax_twin(klen):
    """siv_ctrw_fused_t (K5t, on the transposed [128, W] stream) against
    JAX's siv_ctrw_fused_jnp transposed at W = 6 (not a multiple of 4): a
    random base in every lane, then a base whose word 0 wraps inside row 2."""
    rng = np.random.default_rng(60 + klen)
    kpf = key_planes(expand_key(_rand(rng, klen))).reshape(-1, 1)
    w = 6
    x = rng.integers(0, 2**32, (w, 128), dtype=np.uint32)
    basew = rng.integers(0, 2**32, (1, 128), dtype=np.uint32)
    wrap = basew.copy()
    wrap[0, 0::4] = 2**32 - 32 * 2 - 5
    for base in (basew, wrap):
        with jax.disable_jit():
            want = jps.siv_ctrw_fused_jnp(jnp.asarray(kpf), jnp.asarray(base), jnp.asarray(x))
        got = siv_kernels.siv_ctrw_fused_t(_i32(kpf), _i32(base), _i32(x.T))
        assert got.shape == (128, w)
        assert np.array_equal(_u32(got), np.asarray(want).T)


@pytest.mark.parametrize("klen", (16, 32))
def test_k4t_transposed_plain_version_matches_jax(klen):
    """ghash1_fused_t_plain (K4t's plain version, on the transposed [128, W]
    stream) and the ghash1_fused_t wrapper on the CPU against JAX's
    ghash1_fused_jnp on the transpose at W = 6, with ghmask rows of none,
    the low half, one block and all of their blocks beside random ones, on
    the AES-128 and AES-256 tables."""
    _, _, (_, _, _, jw1t), (_, _, tables) = _setups(klen, 80 + klen)
    rng = np.random.default_rng(90 + klen)
    w = 6
    ghm = rng.integers(0, 2**32, (1, w), dtype=np.uint32)
    ghm[0, :4] = (0, 0x0000FFFF, 0x80000000, 0xFFFFFFFF)
    x_t = rng.integers(0, 2**32, (128, w), dtype=np.uint32)
    with jax.disable_jit():
        want = np.asarray(jps.ghash1_fused_jnp(jnp.asarray(ghm), jw1t, jnp.asarray(x_t.T)))
    got = siv_kernels.ghash1_fused_t_plain(_i32(ghm), tables[5], _i32(x_t))
    assert got.dtype == torch.int8 and got.shape == (128, w)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(siv_kernels.ghash1_fused_t(_i32(ghm), tables[5], _i32(x_t)).numpy(),
                          want)


def test_siv_key_setup_matches_jax():
    """The port's own per-(key, nonce) setup equals the carried-across JAX
    one (tables built with torch against JAX's host numpy)."""
    key, nonce, _, (msg_key, kp, tables) = _setups(32, 7)
    own_key, own_kp, own_tables = tsiv._siv_key_setup(key, nonce, torch.device(CPU))
    assert own_key == msg_key and torch.equal(own_kp, kp)
    for a, b in zip(own_tables[:4] + own_tables[5:], tables[:4] + tables[5:]):
        assert torch.equal(a, b)
    for (aw, am), (bw, bm) in zip(own_tables[4], tables[4]):
        assert torch.equal(aw, bw) and torch.equal(am, bm)


@pytest.mark.parametrize("front_case", ["below front", "wraps mid-message"])
def test_siv_basew_and_ctr_stream_match_jax(front_case):
    """_siv_basew when tag word 0 is below the stream front (the base goes
    negative mod 2^32) and when the counter wraps inside the message: the
    CTR stream equals JAX's stream function and both per-message CTRs."""
    key, nonce, (_, jkp, _, _), (msg_key, kp, _) = _setups(16, 11)
    rng = np.random.default_rng(3)
    n = 65
    w = tsiv._stream_words(n)
    front = 32 * w - (n + 1)
    tag = rng.integers(0, 256, 16, dtype=np.uint8)
    word0 = 5 if front_case == "below front" else 2**32 - 20
    tag[:4] = np.frombuffer(word0.to_bytes(4, "little"), np.uint8)
    base = tag.copy()
    base[15] |= 0x80
    words = base.view(np.uint32)
    want_basew = np.asarray(jsiv._siv_basew(jnp.asarray(words), front))
    assert np.array_equal(_u32(tsiv._siv_basew(_i32(words), front)), want_basew)
    pt = _rand(rng, 16 * n)
    stream = host_stream(pt, front, w)
    assert np.array_equal(stream, j_host_stream(pt, front, w))
    with jax.disable_jit():
        jout = np.asarray(jsiv.gcm_siv_ctr_stream(jkp, jnp.asarray(words), jnp.asarray(stream),
                                                  front))
    tout = tsiv.gcm_siv_ctr_stream(kp, _i32(words), _i32(stream), front)
    assert np.array_equal(_u32(tout), jout)
    ct = _u32(tout).reshape(-1)[4 * front: 4 * (front + n)].tobytes()
    assert ct == j_ctr_xcrypt(msg_key, tag, "gcm_siv", pt)
    assert ct == ctr_xcrypt(msg_key, torch.from_numpy(tag), "gcm_siv", pt)


def test_stream_functions_match_jax():
    """polyval_stream, gcm_siv_ctr_stream and _siv_open_stream against the
    JAX functions of the same names (their off-TPU twins), AES-256, 65
    blocks, then the bulk seal they make against JAX gcm_siv_encrypt."""
    key, nonce, (jmsg_key, jkp, jtables, jw1t), (msg_key, kp, tables) = _setups(32, 77)
    rng = np.random.default_rng(77)
    n = 65
    pt = _rand(rng, 16 * n)
    w = tsiv._stream_words(n)
    front = 32 * w - (n + 1)
    buf = host_stream(pt, front, w)
    buf.reshape(-1)[-4:] = tsiv._len_block_le(n).view(np.uint32)
    expect = j_gcm_siv_encrypt(key, nonce, b"", pt)
    base = np.frombuffer(expect[-16:], np.uint8).copy()
    base[15] |= 0x80
    words = base.view(np.uint32)
    ct_stream = host_stream(expect[:-16], front, w)
    with jax.disable_jit():
        jpv = np.asarray(jsiv.polyval_stream(jtables, jw1t, jnp.asarray(buf), n))
        jct = np.asarray(jsiv.gcm_siv_ctr_stream(jkp, jnp.asarray(words), jnp.asarray(buf),
                                                 front))
        jptw, jpv2 = jsiv._siv_open_stream(jkp, jnp.asarray(words), jtables, jw1t,
                                           jnp.asarray(ct_stream), n)
    tpv = tsiv.polyval_stream(tables, _i32(buf), n)
    assert np.array_equal(tpv.numpy(), jpv)
    assert np.array_equal(_u32(tsiv.gcm_siv_ctr_stream(kp, _i32(words), _i32(buf), front)), jct)
    tptw, tpv2 = tsiv._siv_open_stream(kp, _i32(words), tables, _i32(ct_stream), n)
    assert np.array_equal(_u32(tptw), np.asarray(jptw))
    assert np.array_equal(tpv2.numpy(), np.asarray(jpv2))
    assert bytes(tsiv.siv_tag(msg_key, nonce, tpv).numpy()) == expect[-16:]


@pytest.mark.parametrize("nblocks", [1, 31, 32, 65])
def test_bulk_seal_open_on_cpu_match_jax_gcm_siv_encrypt(nblocks):
    rng = np.random.default_rng(100 + nblocks)
    key, nonce, pt = _rand(rng, 16), _rand(rng, 12), _rand(rng, 16 * nblocks)
    blob = aes.gcm_siv_seal(key, nonce, pt, device=CPU)
    assert blob == j_gcm_siv_encrypt(key, nonce, b"", pt)
    assert aes.gcm_siv_open(key, nonce, blob, device=CPU) == pt
    bad = bytearray(blob)
    bad[-16] ^= 0x80
    with pytest.raises(AuthenticationError):
        aes.gcm_siv_open(key, nonce, bytes(bad), device=CPU)


def test_bulk_mask_marks_the_stream_tail():
    """position_mask(w, lo, hi) is JAX's _ghm_mask."""
    for lo, hi in ((0, 1024), (958, 1024), (958, 1023), (1, 2)):
        got = _u32(position_mask(32, lo, hi, CPU))
        assert np.array_equal(got, jsiv._ghm_mask(32, lo, hi))


def test_purge_reaches_the_gcm_siv_caches():
    from micro_aes_tpu_torch.modes import gcm_siv
    from micro_aes_tpu_torch.utils.keycache import registered_key_caches

    key, nonce = bytes(16), bytes(12)
    aes.gcm_siv_seal(key, nonce, bytes(32), device=CPU)
    aes.gcm_siv_encrypt(key, nonce, b"a", b"b", device=CPU)
    caches = (tsiv._siv_key_setup, gcm_siv._derive_keys, gcm_siv._polyval_matrix_cached)
    assert all(c in registered_key_caches() and c.cache_info().currsize for c in caches)
    aes.purge_key_caches()
    assert all(c.cache_info().currsize == 0 for c in caches)
