"""Parity of the port's RFC 3394 key wrap with the JAX package, on the CPU:
the main.c answers, per-message key_wrap/key_unwrap, K16's plain versions in
both message maps (ops/kw_kernels) and the KW batches (modes/bulk).

Inputs come from numpy seeds and go through both packages; every comparison
is bit-exact.  The JAX wheel is a lax.scan: eagerly (jax.disable_jit) it
costs seconds per message and about 5 s vmapped over 1,024 messages, jitted
0.3-1 s per compile, so JAX compiles six shapes here (the vmapped scans at
B = 1024, n = 2, the batch at B = 40, n = 3 and the per-message wheel at
n = 4, each both ways) and runs the n = 2 message eagerly.  K16's Pallas form
is never run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.bulk as jbulk
import micro_aes_tpu.modes.kw as jkw
from micro_aes_tpu.ops.pallas_chain import wide_ok as j_wide_ok
from micro_aes_tpu.ops.pallas_chain import wide_perm as j_wide_perm

import micro_aes_tpu_torch as aes
import micro_aes_tpu_torch.modes.bulk as tbulk
from micro_aes_tpu_torch import AuthenticationError, DataLengthError
from micro_aes_tpu_torch.core.bitslice import key_planes_packed, wide_ok, wide_perm
from micro_aes_tpu_torch.ops import kw_kernels as kk
from micro_aes_tpu_torch.testing import kat

CPU = "cpu"


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("klen,want", kat.KW_VECTORS, ids=("KW128", "KW192", "KW256"))
def test_kw_main_c_answers(klen, want):
    kek, secret = kat.SECRET_KEY[:klen], kat.SECOND_KEY[:klen]
    assert aes.key_wrap(kek, secret, device=CPU) == want
    assert aes.key_unwrap(kek, want, device=CPU) == secret
    assert tbulk.key_wrap_batch([kek], [secret], device=CPU) == [want]
    assert tbulk.key_unwrap_batch([kek], [want], device=CPU) == [secret]


@pytest.mark.parametrize("n,klen,eager", [(2, 16, True), (4, 32, False)])
def test_kw_per_message_matches_jax(n, klen, eager):
    rng = np.random.default_rng(40 + n + klen)
    kek, secret = _rand(rng, klen), _rand(rng, 8 * n)
    with jax.disable_jit(eager):
        want = jkw.key_wrap(kek, secret)
        back = jkw.key_unwrap(kek, want)
    assert aes.key_wrap(kek, secret, device=CPU) == want
    assert aes.key_unwrap(kek, want, device=CPU) == back == secret


def _wheels_jax(rks, data, n, unwrap):
    """The JAX package's vmapped per-message scans -> uint8[B,n+1,8]."""
    rksj = jnp.asarray(rks)
    if unwrap:
        a, r = jax.vmap(lambda rk, av, rv: jkw._unwrap_scan(rk, av, rv, n))(
            rksj, jnp.asarray(data[:, 0]), jnp.asarray(data[:, 1:]))
    else:
        a0 = jnp.full((data.shape[0], 8), 0xA6, jnp.uint8)
        a, r = jax.vmap(lambda rk, av, rv: jkw._wrap_scan(rk, av, rv, n))(
            rksj, a0, jnp.asarray(data))
    return np.concatenate([np.asarray(a)[:, None], np.asarray(r)], axis=1)


def test_kw_wheel_plain_versions_match_jax_scans():
    """K16's plain versions, natural map and wide map (keys packed from
    rks[wide_perm(B)]), wrap and unwrap, against the JAX package's vmapped
    _wrap_scan/_unwrap_scan, at the least B that takes the wide map."""
    rng = np.random.default_rng(83)
    b, n = 1024, 2
    assert wide_ok(b) and not wide_ok(b - 32)
    rks = jbulk.stack_round_keys([_rand(rng, 16) for _ in range(b)])
    secrets = rng.integers(0, 256, (b, n, 8), dtype=np.uint8)
    want = _wheels_jax(rks, secrets, n, False)
    kpw = torch.from_numpy(key_planes_packed(rks).view(np.int32))
    kpw_w = torch.from_numpy(key_planes_packed(rks[wide_perm(b)]).view(np.int32))
    x = torch.from_numpy(secrets)
    assert np.array_equal(kk.kw_packed(kpw, x).numpy(), want)
    assert np.array_equal(kk.kw_packed_fused(kpw_w, x).numpy(), want)
    wrapped = want.copy()
    wrapped[:3, 0, 0] ^= 1  # tampered ICVs unwrap to a wrong A
    back = _wheels_jax(rks, wrapped, n, True)
    w = torch.from_numpy(wrapped)
    assert np.array_equal(kk.kw_packed(kpw, w, unwrap=True).numpy(), back)
    assert np.array_equal(kk.kw_packed_fused(kpw_w, w, unwrap=True).numpy(), back)
    assert np.all(back[3:, 0] == 0xA6) and np.array_equal(back[3:, 1:], secrets[3:])
    assert not np.any(np.all(back[:3, 0] == 0xA6, axis=1))


def test_kw_batch_matches_jax():
    """One (n, key size) group through the batches against the JAX package's
    key_wrap_batch/key_unwrap_batch (its vmapped-scan route on the CPU), with
    a tampered member."""
    rng = np.random.default_rng(91)
    b, n = 40, 3  # pads to 64: the natural map
    keks = [_rand(rng, 24) for _ in range(b)]
    secrets = [_rand(rng, 8 * n) for _ in range(b)]
    want = jbulk.key_wrap_batch(keks, secrets)
    got = tbulk.key_wrap_batch(keks, secrets, device=CPU)
    assert got == want
    tampered = bytearray(got[7])
    tampered[9] ^= 0x10
    got[7] = bytes(tampered)
    want_back = jbulk.key_unwrap_batch(keks, got)
    back = tbulk.key_unwrap_batch(keks, got, device=CPU)
    assert back == want_back
    assert back[7] is None and back[:7] + back[8:] == secrets[:7] + secrets[8:]


def test_kw_ragged_batch_matches_per_message():
    """A ragged batch (KEKs of 16/24/32 bytes in turn, 16- and 24-byte secrets,
    then a group of 1,024 AES-256 16-byte secrets, all in one wheel) against
    the port's per-message answers, both ways."""
    rng = np.random.default_rng(92)
    keks = [_rand(rng, (16, 24, 32)[i % 3]) for i in range(6)]
    secrets = [_rand(rng, 16 + 8 * (i // 3)) for i in range(6)]
    keks += [_rand(rng, 32) for _ in range(1024)]
    secrets += [_rand(rng, 16) for _ in range(1024)]
    wrapped = tbulk.key_wrap_batch(keks, secrets, device=CPU)
    for i in (0, 4, 5, 6, 1029):
        assert wrapped[i] == aes.key_wrap(keks[i], secrets[i], device=CPU)
    assert tbulk.key_unwrap_batch(keks, wrapped, device=CPU) == secrets


def test_kw_errors():
    kek = bytes(range(16))
    with pytest.raises(DataLengthError):
        aes.key_wrap(kek, bytes(8), device=CPU)  # one semiblock
    with pytest.raises(DataLengthError):
        aes.key_wrap(kek, bytes(17), device=CPU)  # a partial semiblock
    with pytest.raises(DataLengthError):
        aes.key_unwrap(kek, bytes(16), device=CPU)  # two semiblocks
    with pytest.raises(DataLengthError):
        aes.key_unwrap(kek, bytes(25), device=CPU)
    with pytest.raises(DataLengthError):
        tbulk.key_wrap_batch([kek, kek], [bytes(16), bytes(12)], device=CPU)
    with pytest.raises(DataLengthError):
        tbulk.key_unwrap_batch([kek], [bytes(16)], device=CPU)
    bad = bytearray(aes.key_wrap(kek, kat.SECOND_KEY[:16], device=CPU))
    bad[0] ^= 1
    with pytest.raises(AuthenticationError):
        aes.key_unwrap(kek, bytes(bad), device=CPU)
    assert tbulk.key_unwrap_batch([kek, kek], [bytes(bad), bytes(bad)], device=CPU) == [None,
                                                                                          None]
    with pytest.raises(ValueError):
        kk.kw_packed_fused(torch.zeros((11, 8, 16, 31), dtype=torch.int32),
                           torch.zeros((992, 2, 8), dtype=torch.uint8))


def test_wide_map_matches_jax():
    """wide_tile/wide_ok/wide_perm against the JAX package's, and the head of
    wide_perm(1024) (T = 32: slot 32*wg + j holds message 32j + wg)."""
    assert list(wide_perm(1024)[:4]) == [0, 32, 64, 96]
    assert list(wide_perm(1024)[32:35]) == [1, 33, 65]
    for b in (1024, 2048, 4096, 8192, 96 * 32, 160 * 32):
        assert wide_ok(b) == j_wide_ok(b)
        if wide_ok(b):
            assert np.array_equal(wide_perm(b), j_wide_perm(b))
            assert sorted(wide_perm(b)) == list(range(b))
    assert not wide_ok(992) and not wide_ok(1000)
