"""Parity of the port's bulk AES-GCM path (micro_aes_tpu_torch: the K1/K2/K3
plain versions and modes/seal) with the JAX package, on the CPU.

The JAX side runs its plain references (seal_fused_jnp, ctr_fused_jnp,
encrypt_planes/decrypt_planes, and gcm_seal/gcm_open/ctr_bulk, which take
those references off the TPU) eagerly, under jax.disable_jit, to skip XLA
compiles.  Shapes stay small (W <= 16 words, messages of 1/33/257 blocks);
every comparison is bit-exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import micro_aes_tpu.modes.seal as jseal
import micro_aes_tpu.ops.pallas_seal as jps
from micro_aes_tpu.ops.pallas_cipher import cipher_planes_auto
import micro_aes_tpu_torch.modes.seal as tseal
from micro_aes_tpu_torch import AuthenticationError
from micro_aes_tpu_torch.ops import cipher_kernel, seal_kernels
from micro_aes_tpu_torch.ops.ghash_bulk import pack_level1
from micro_aes_tpu_torch.testing.kat import GCM_SPEC_VECTORS

KEY_LENS = (16, 24, 32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.uint32).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


def _key(klen, seed=0):
    return np.random.default_rng(seed + klen).integers(0, 256, klen, dtype=np.uint8).tobytes()


def _kernel_inputs(klen, w, seed, lo0=0):
    """Random K1/K3 operands: key planes, J0 bits, 32-aligned lo (from lo0,
    mod 2^32) with a random 24-bit hi, validity mask, the level-1 table W1
    [4096, 128] (JAX's K1 takes W1^T, the port's pack_level1(W1)) and
    stream."""
    rng = np.random.default_rng(seed)
    kp, tables = jseal.gcm_key_setup(_key(klen, seed))
    j0 = rng.integers(0, 256, 16, dtype=np.uint8)
    j0c = (((j0[:, None] >> np.arange(8)) & 1).T.reshape(128, 1).astype(np.uint32)
           * np.uint32(0xFFFFFFFF))
    lo = ((np.arange(w, dtype=np.uint64) * 32 + lo0) % 2**32).astype(np.uint32)
    lohi = np.stack([lo, rng.integers(0, 1 << 24, w, dtype=np.uint32)])
    ghm = rng.integers(0, 2**32, (1, w), dtype=np.uint32)
    pt = rng.integers(0, 2**32, (w, 128), dtype=np.uint32)
    w1 = np.asarray(tables[0]).astype(np.int8)
    return np.asarray(kp).reshape(-1, 1), j0c, lohi, ghm, w1, pt


@pytest.mark.parametrize("opening", [False, True], ids=["seal", "open"])
@pytest.mark.parametrize("klen", KEY_LENS)
def test_k1_plain_matches_seal_fused_jnp(klen, opening):
    """The K1 plain version vs the JAX twin: ciphertext stream AND the
    level-1 GHASH partials s1, across a counter wrap."""
    kpf, j0c, lohi, ghm, w1, pt = _kernel_inputs(klen, 16, klen, lo0=0xFFFFFF00)
    with jax.disable_jit():
        jct, js1 = jps.seal_fused_jnp(*map(jnp.asarray, (kpf, j0c, lohi, ghm, w1.T, pt)),
                                      bits_from_input=opening)
    tct, ts1 = seal_kernels.seal_fused(_i32(kpf), _i32(j0c), _i32(lohi), _i32(ghm),
                                       torch.from_numpy(pack_level1(w1)), _i32(pt), opening)
    assert np.array_equal(_u32(tct), np.asarray(jct))
    assert ts1.dtype == torch.int8 and np.array_equal(ts1.numpy(), np.asarray(js1))


@functools.lru_cache(maxsize=None)
def _k1t_case(klen, opening):
    """K1 operands at W = 8 and JAX's seal_fused_jnp on them (rows are
    independent, so the first W rows of both serve any W <= 8)."""
    kpf, j0c, lohi, ghm, w1, pt = _kernel_inputs(klen, 8, 5 + klen)
    with jax.disable_jit():
        jct, js1 = jps.seal_fused_jnp(*map(jnp.asarray, (kpf, j0c, lohi, ghm, w1.T, pt)),
                                      bits_from_input=opening)
    return (kpf, j0c, lohi, ghm, w1, pt), (np.asarray(jct), np.asarray(js1))


@pytest.mark.parametrize("w", [5, 8])
@pytest.mark.parametrize("opening", [False, True], ids=["seal", "open"])
@pytest.mark.parametrize("klen", KEY_LENS)
def test_k1t_transposed_contract(klen, opening, w):
    """seal_fused_t (K1t, on the transposed [128, W] stream the TPU runs)
    against JAX's seal_fused_jnp transposed, both directions, at a W that
    is a multiple of 4 and one that is not."""
    (kpf, j0c, lohi, ghm, w1, pt), (jct, js1) = _k1t_case(klen, opening)
    args = (_i32(kpf), _i32(j0c), _i32(lohi[:, :w]), _i32(ghm[:, :w]),
            torch.from_numpy(pack_level1(w1)))
    tct_t, ts1 = seal_kernels.seal_fused_t(*args, _i32(pt[:w].T), opening)
    assert tct_t.shape == (128, w)
    assert np.array_equal(_u32(tct_t), jct[:w].T)
    assert np.array_equal(ts1.numpy(), js1[:, :w])


@pytest.mark.parametrize("klen", KEY_LENS)
def test_k3_plain_matches_ctr_fused_jnp_across_a_lo_wrap(klen):
    kpf, j0c, lohi, _, _, pt = _kernel_inputs(klen, 12, 50 + klen, lo0=0xFFFFFE00)
    with jax.disable_jit():
        want = jps.ctr_fused_jnp(*map(jnp.asarray, (kpf, j0c, lohi, pt)))
    got = seal_kernels.ctr_fused(_i32(kpf), _i32(j0c), _i32(lohi), _i32(pt))
    assert np.array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("decrypt", [False, True], ids=["enc", "dec"])
@pytest.mark.parametrize("klen", KEY_LENS)
def test_k2_plain_matches_jax(klen, decrypt):
    kp, _ = jseal.gcm_key_setup(_key(klen, 7))
    planes = np.random.default_rng(klen).integers(0, 2**32, (8, 16, 6), dtype=np.uint32)
    with jax.disable_jit():
        want = cipher_planes_auto(kp, jnp.asarray(planes), decrypt)
    got = cipher_kernel.cipher_planes(_i32(kp), _i32(planes), decrypt)
    assert np.array_equal(_u32(got), np.asarray(want))


def test_wrappers_take_only_cpu_or_cuda():
    """Dispatch is on the tensor's device: CPU runs the plain version, CUDA
    the kernel; any other device raises instead of falling back."""
    planes = torch.zeros((8, 16, 1), dtype=torch.int32, device="meta")
    kp = torch.zeros((11, 8, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cipher_kernel.cipher_planes(kp, planes)
    with pytest.raises(ValueError):
        seal_kernels.ctr_fused(kp.reshape(-1, 1), torch.zeros((128, 1), dtype=torch.int32, device="meta"),
                               torch.zeros((2, 1), dtype=torch.int32, device="meta"),
                               torch.zeros((1, 128), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("klen", KEY_LENS)
def test_key_setup_matches_jax_and_key_setup_from_jax(klen):
    key = _key(klen, 9)
    jkp, jtables = jseal.gcm_key_setup(key)
    kp, tables = tseal.gcm_key_setup(key, device="cpu")
    fkp, ftables = tseal.key_setup_from_jax(
        np.asarray(jkp), jax.tree_util.tree_map(np.asarray, jtables), device="cpu")
    assert np.array_equal(_u32(kp), np.asarray(jkp))
    assert torch.equal(fkp, kp)
    for a, b, c in zip(tables[:4], ftables[:4], jtables[:4]):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(c))
    for (aw, am), (bw, bm) in zip(tables[4], ftables[4]):
        assert torch.equal(aw, bw) and torch.equal(am, bm)
    assert torch.equal(tables[5], ftables[5])


@pytest.mark.parametrize("opening", [False, True], ids=["seal", "open"])
def test_fused_seal_stream_from_the_jax_state(opening):
    """The port's stream core, fed the JAX package's per-key state, returns
    the JAX core's (stream, E(J0), GHASH partial)."""
    key, n = _key(32, 11), 70
    rng = np.random.default_rng(11)
    jkp, jtables = jseal.gcm_key_setup(key)
    kp, tables = tseal.key_setup_from_jax(
        np.asarray(jkp), jax.tree_util.tree_map(np.asarray, jtables), device="cpu")
    j0 = np.zeros(16, np.uint8)
    j0[:12] = rng.integers(0, 256, 12, dtype=np.uint8)
    j0[15] = 1
    w = tseal.seal_stream_words(n)
    assert w == jseal.seal_stream_words(n)
    stream = tseal.host_stream(rng.integers(0, 256, 16 * n, dtype=np.uint8).tobytes(), 2, w)
    with jax.disable_jit():
        jct, jek, jacc = jseal.fused_seal_stream(jkp, jtables, jnp.asarray(j0),
                                                 jnp.asarray(stream), n, opening)
    tct, tek, tacc = tseal.fused_seal_stream(kp, tables, torch.from_numpy(j0),
                                             _i32(stream), n, opening)
    assert np.array_equal(_u32(tct), np.asarray(jct))
    assert np.array_equal(tek.numpy(), np.asarray(jek))
    assert np.array_equal(tacc.numpy(), np.asarray(jacc))
    assert tseal.fused_trailing_pad(n) == jseal.fused_trailing_pad(n)


@pytest.mark.parametrize("n", [1, 30, 31, 1000, 1 << 20])
def test_stream_widths_match_jax(n):
    """The one rounding rule (stream_words) gives the JAX package's
    off-TPU fused-seal width, and whole 32-position words for CTR."""
    assert tseal.seal_stream_words(n) == jseal.seal_stream_words(n)
    assert tseal.fused_trailing_pad(n) == jseal.fused_trailing_pad(n)
    w = tseal.stream_words(n + 1)
    assert 32 * (w - seal_kernels.SEAL_WORD_ALIGN) < n + 1 <= 32 * w
    assert w % seal_kernels.SEAL_WORD_ALIGN == 0


def test_stream_views_match_jax():
    blocks = np.random.default_rng(19).integers(0, 256, (45, 16), dtype=np.uint8)
    w = tseal.seal_stream_words(45)
    stream = seal_kernels.bytes_to_stream(torch.from_numpy(blocks), 2, w)
    assert np.array_equal(_u32(stream), np.asarray(jps.bytes_to_stream(jnp.asarray(blocks), 2, w)))
    assert np.array_equal(_u32(stream), tseal.host_stream(blocks.tobytes(), 2, w))
    assert np.array_equal(seal_kernels.stream_to_bytes(stream, 2, 45).numpy(), blocks)
    assert tseal.host_unstream(_u32(stream), 2, 45 * 16) == blocks.tobytes()


@pytest.mark.parametrize("n", [1, 29, 30, 31, 62, 257, 1000])
def test_ghash_mask_marks_positions_2_to_n_plus_1(n):
    w = tseal.seal_stream_words(n)
    pv = np.zeros(32 * w, np.uint32)
    pv[2: n + 2] = 1
    want = np.zeros(w, np.uint32)
    for j in range(32):  # the JAX package's per-lane construction
        want |= pv[j::32] << np.uint32(j)
    assert np.array_equal(_u32(tseal.ghash_mask(n, w, "cpu"))[0], want)


@pytest.mark.parametrize("aad_len", [0, 37], ids=["no_aad", "aad"])
@pytest.mark.parametrize("klen,nblocks", [(16, 1), (24, 33), (32, 257)])
def test_gcm_seal_and_open_match_jax(klen, nblocks, aad_len):
    rng = np.random.default_rng(klen * nblocks + aad_len)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    pt = rng.integers(0, 256, 16 * nblocks, dtype=np.uint8).tobytes()
    aad = rng.integers(0, 256, aad_len, dtype=np.uint8).tobytes()
    with jax.disable_jit():
        want = jseal.gcm_seal(key, nonce, pt, aad=aad)
    blob = tseal.gcm_seal(key, nonce, pt, aad, device="cpu")
    assert blob == want
    assert tseal.gcm_open(key, nonce, want, aad, device="cpu") == pt
    if aad_len:  # and the other way round: JAX opens the port's blob
        with jax.disable_jit():
            assert jseal.gcm_open(key, nonce, blob, aad=aad) == pt


@pytest.mark.parametrize("klen", KEY_LENS)
def test_ctr_bulk_matches_jax(klen):
    rng = np.random.default_rng(300 + klen)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    iv = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, 16 * 45, dtype=np.uint8).tobytes()
    with jax.disable_jit():
        want = jseal.ctr_bulk(key, iv, data)
    got = tseal.ctr_bulk(key, iv, data, device="cpu")
    assert got == want
    assert tseal.ctr_bulk(key, iv, got, device="cpu") == data


def test_v2_gcm_seal_kernel_matches_jax():
    key = _key(32, 13)
    rng = np.random.default_rng(13)
    j0 = np.zeros(16, np.uint8)
    j0[:12] = rng.integers(0, 256, 12, dtype=np.uint8)
    j0[15] = 1
    pt = rng.integers(0, 256, (100, 16), dtype=np.uint8)
    jkp, jtables = jseal.gcm_key_setup(key)
    with jax.disable_jit():
        jct, jtag = jseal.gcm_seal_kernel(jkp, jtables, jnp.asarray(j0), jnp.asarray(pt))
    kp, tables = tseal.gcm_key_setup(key, device="cpu")
    ct, tag = tseal.gcm_seal_kernel(kp, tables, torch.from_numpy(j0), torch.from_numpy(pt))
    assert np.array_equal(ct.numpy(), np.asarray(jct))
    assert np.array_equal(tag.numpy(), np.asarray(jtag))


@pytest.mark.parametrize("vec", GCM_SPEC_VECTORS, ids=lambda v: v[0])
def test_gcm_spec_vectors(vec):
    _, key, iv, pt, ct, tag = vec
    assert tseal.gcm_seal(key, iv, pt, device="cpu") == ct + tag
    assert tseal.gcm_open(key, iv, ct + tag, device="cpu") == pt


def test_gcm_open_rejects_tampering_before_releasing_plaintext():
    key, nonce = _key(32, 17), bytes(range(12))
    pt = np.random.default_rng(17).integers(0, 256, 16 * 40, dtype=np.uint8).tobytes()
    blob = tseal.gcm_seal(key, nonce, pt, b"hdr", device="cpu")
    assert tseal.gcm_open(key, nonce, blob, b"hdr", device="cpu") == pt
    for bad, aad in ((blob[:-1] + bytes([blob[-1] ^ 1]), b"hdr"),
                     (bytes([blob[0] ^ 0x80]) + blob[1:], b"hdr"),
                     (blob, b"other")):
        with pytest.raises(AuthenticationError):
            tseal.gcm_open(key, nonce, bad, aad, device="cpu")


def test_bulk_path_argument_checks():
    with pytest.raises(ValueError):
        tseal.gcm_seal(bytes(16), bytes(11), bytes(16), device="cpu")
    with pytest.raises(ValueError):
        tseal.gcm_seal(bytes(16), bytes(12), bytes(15), device="cpu")
    with pytest.raises(ValueError):
        tseal.gcm_open(bytes(16), bytes(12), bytes(8), device="cpu")
