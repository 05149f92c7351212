"""The port's Poly1305-AES (micro_aes_tpu_torch modes/poly1305 and the bulk
fold of ops/poly_bulk) against the JAX package, on the CPU.

The JAX side runs eagerly or through its host Horner loop: its power tables
are host-built constants, its limb and carry helpers run eagerly at T = 64,
and every tag is compared with its `poly1305_aes` below the bulk threshold
(or with the threshold raised), which the JAX package's own tests hold
against its device fold.  No jitted JAX fold is called.  Every comparison is
bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from micro_aes_tpu.modes import poly1305 as jpoly
from micro_aes_tpu.ops import poly_bulk as jbulk

import micro_aes_tpu_torch as aes
from micro_aes_tpu_torch.modes import poly1305 as tpoly
from micro_aes_tpu_torch.ops import poly_bulk as tbulk
from micro_aes_tpu_torch.testing import kat, rsp

CPU = torch.device("cpu")


def _rand(rng, n) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n, levels", [(32, 1), (64, 2), (2048, 3)])
def test_power_tables_match_jax(n, levels):
    """Whole-limb float64 tables == JAX's int8 digit pairs, lo + 128 * hi."""
    r = tpoly._clamp_r(_rand(np.random.default_rng(n), 16))
    got = tbulk.poly_power_tables(r, n, CPU)
    want = jbulk.poly_power_tables(r, n)
    assert len(got) == len(want) == levels
    for wt, (lo, hi) in zip(got, want):
        assert wt.dtype == torch.float64 and tuple(wt.shape) == (15, 480)
        ref = np.asarray(lo).astype(np.int64) + 128 * np.asarray(hi).astype(np.int64)
        np.testing.assert_array_equal(wt.numpy().astype(np.int64), ref)


def test_chunk_limbs_and_normalize_match_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, (4, 64), dtype=np.uint32)
    words[:, 0] = 0xFFFFFFFF  # every limb that straddles a word boundary set
    pad = rng.integers(0, 2, 64).astype(np.int32)
    got = tbulk.chunk_limbs_from_words(torch.from_numpy(words.view(np.int32)),
                                       torch.from_numpy(pad))
    want = jbulk.chunk_limbs_from_words(jnp.asarray(words), jnp.asarray(pad))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = rng.integers(0, 1 << 27, (15, 64)).astype(np.int32)
    y[:, 0] = (1 << 27) - 1  # the bound of a level's output
    np.testing.assert_array_equal(tbulk._normalize(torch.from_numpy(y)).numpy(),
                                  np.asarray(jbulk._normalize(jnp.asarray(y))))


@pytest.mark.parametrize("length", [0, 1, 16, 17, 1023, 1024, 16 * 1024 + 5, 40000])
def test_bulk_matches_jax(length):
    rng = np.random.default_rng(7 + length)
    keys, nonce, data = _rand(rng, 48), _rand(rng, 16), _rand(rng, length)
    want = jpoly.poly1305_aes(keys, nonce, data)  # JAX's Horner loop (< threshold)
    assert tpoly.poly1305_aes_bulk(keys, nonce, data, device=CPU) == want
    assert aes.poly1305_aes(keys, nonce, data, device=CPU) == want


def test_bulk_span_levels():
    """> 32^2 chunks: three fold levels."""
    rng = np.random.default_rng(8)
    keys, nonce, data = _rand(rng, 48), _rand(rng, 16), _rand(rng, 16 * 1100)
    assert tpoly.poly1305_aes_bulk(keys, nonce, data, device=CPU) == \
        jpoly.poly1305_aes(keys, nonce, data)


def test_routes_bulk_at_threshold(monkeypatch):
    """poly1305_aes sends >= _BULK_THRESHOLD bytes to the device fold; the
    Horner loop (threshold raised) and JAX's Horner loop agree with it."""
    rng = np.random.default_rng(9)
    keys, nonce = _rand(rng, 48), _rand(rng, 16)
    data = _rand(rng, tpoly._BULK_THRESHOLD + 7)
    calls = []
    bulk = tpoly.poly1305_aes_bulk
    monkeypatch.setattr(tpoly, "poly1305_aes_bulk",
                        lambda *a, **k: calls.append(1) or bulk(*a, **k))
    routed = tpoly.poly1305_aes(keys, nonce, data, device=CPU)
    assert calls == [1]
    monkeypatch.setattr(tpoly, "_BULK_THRESHOLD", 1 << 60)
    monkeypatch.setattr(jpoly, "_BULK_THRESHOLD", 1 << 60)
    assert tpoly.poly1305_aes(keys, nonce, data, device=CPU) == routed
    assert jpoly.poly1305_aes(keys, nonce, data) == routed
    assert calls == [1]


def test_main_c_vector():
    args = (kat.CIPHER_KEY, kat.IVEC, kat.PLAINTEXT)
    assert aes.poly1305_aes(*args, device=CPU) == kat.POLY1305_128
    assert tpoly.poly1305_aes_bulk(*args, device=CPU) == kat.POLY1305_128


@pytest.mark.parametrize("klen", [16, 24, 32])
def test_key_sizes_match_jax(klen):
    """AES-128/192/256 || r: AES_k(nonce) on the port's byte cipher."""
    rng = np.random.default_rng(klen)
    keys, nonce, data = _rand(rng, klen + 16), _rand(rng, 16), _rand(rng, 100)
    want = jpoly.poly1305_aes(keys, nonce, data)
    assert aes.poly1305_aes(keys, nonce, data, device=CPU) == want
    assert tpoly.poly1305_aes_bulk(keys, nonce, data, device=CPU) == want


def test_tv_corpus():
    """The reference's Poly1305AES128.tv through the bulk fold and the
    routed entry point (skips where the corpus is not present)."""
    path = rsp.REFERENCE_VECTORS / "Poly1305AES128.tv"
    if not path.exists():
        pytest.skip(f"reference corpus not present: {path}")
    recs = rsp.load_poly1305()
    assert len(recs) == 96
    for r in recs:
        msg = rsp.hexval(r, "Msg")[: int(r["Mlen"])]
        args = (rsp.hexval(r, "Keys"), rsp.hexval(r, "Nonce"), msg)
        want = rsp.hexval(r, "PolyMac")
        assert tpoly.poly1305_aes_bulk(*args, device=CPU) == want, r["Count"]
        assert aes.poly1305_aes(*args, device=CPU) == want, r["Count"]
