"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at small shapes (bit-exact), and the bulk AES-GCM / CTR,
multi-key batch GCM, GCM-SIV, XTS sector, OCB, chain and CCM/EAX/SIV entry
points on CUDA against the same calls on the CPU.

Marked `cuda`; every test skips without an NVIDIA GPU (the kernels have no
CPU or interpret mode).  On a machine with one (tests/conftest.py imports
jax, which this file does not need):
    python -m pytest --noconftest -o addopts='' tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from micro_aes_tpu_torch.modes import seal
from micro_aes_tpu_torch.ops.cipher_kernel import cipher_planes, cipher_planes_plain
from micro_aes_tpu_torch.ops.counter import j0_planes, lohi_words
from micro_aes_tpu_torch.ops.seal_kernels import (
    ctr_fused,
    ctr_fused_plain,
    seal_fused,
    seal_fused_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _words(rng, dev, *shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                            .view(np.int32)).to(dev)


@pytest.mark.parametrize("klen", (16, 24, 32))
def test_kernels_match_plain_versions(dev, klen):
    rng = np.random.default_rng(klen)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    kp, tables = seal.gcm_key_setup(key, device=dev)
    kpf, w = kp.reshape(-1, 1), 300
    j0 = torch.from_numpy(rng.integers(0, 256, 16, dtype=np.uint8)).to(dev)
    j0[12:16] = torch.tensor([0xFF, 0xFF, 0xF8, 0x01], dtype=torch.uint8)  # lo wraps
    j0c, lohi = j0_planes(j0), lohi_words(j0, w, -1)
    ghm, pt = _words(rng, dev, 1, w), _words(rng, dev, w, 128)
    for opening in (False, True):
        got = seal_fused(kpf, j0c, lohi, ghm, tables[5], pt, opening)
        want = seal_fused_plain(kpf, j0c, lohi, ghm, tables[5], pt, opening)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(ctr_fused(kpf, j0c, lohi, pt), ctr_fused_plain(kpf, j0c, lohi, pt))
    planes = _words(rng, dev, 8, 16, w)
    for decrypt in (False, True):
        assert torch.equal(cipher_planes(kp, planes, decrypt),
                           cipher_planes_plain(kp, planes, decrypt))
    torch.cuda.synchronize()


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_gcm_seal_does_not_depend_on_matmul_precision(dev, precision):
    """The GF(2) products are float64, so TF32 or bf16 matmul settings
    (common in serving processes) leave the tag exact."""
    rng = np.random.default_rng(5)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    pt = rng.integers(0, 256, 16 * 3000, dtype=np.uint8).tobytes()
    aad = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    want = seal.gcm_seal(key, nonce, pt, aad, device="cpu")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        assert seal.gcm_seal(key, nonce, pt, aad, device=dev) == want
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("klen,nblocks", [(16, 1), (24, 33), (32, 4000)])
def test_entry_points_on_cuda_match_cpu(dev, klen, nblocks):
    rng = np.random.default_rng(nblocks)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    pt = rng.integers(0, 256, 16 * nblocks, dtype=np.uint8).tobytes()
    aad = rng.integers(0, 256, 50, dtype=np.uint8).tobytes()
    blob = seal.gcm_seal(key, nonce, pt, aad, device=dev)
    assert blob == seal.gcm_seal(key, nonce, pt, aad, device="cpu")
    assert seal.gcm_open(key, nonce, blob, aad, device=dev) == pt
    ct = seal.ctr_bulk(key, nonce, pt, device=dev)
    assert ct == seal.ctr_bulk(key, nonce, pt, device="cpu")


def _chain_operands(rng, dev, klen, lanes, nb):
    """Random K10 operands: lane-packed keys, a halving table of random H,
    counter bases near a carry into byte 9, random masks."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.ops.chain import ghash_halving_table
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(lanes)]
    kpw = u32_tensor(key_planes_packed(stack_round_keys(keys)), dev)
    h = torch.from_numpy(rng.integers(0, 256, (lanes, 16), dtype=np.uint8)).to(dev)
    c0 = rng.integers(0, 256, (lanes, 16), dtype=np.uint8)
    c0[:, 12:16] = 0xFF  # the low word wraps on the first step
    c0[::2, 9:12] = [0x00, 0xFF, 0xFF]  # and carries into byte 9 on even lanes

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    return (kpw, ghash_halving_table(h), torch.from_numpy(c0).to(dev), u8(lanes, 16),
            u8(lanes, nb, 16), _words(rng, dev, nb, lanes // 32),
            _words(rng, dev, nb, lanes // 32), _words(rng, dev, nb, lanes // 32),
            _words(rng, dev, nb, lanes // 32), u8(lanes, 16), u8(lanes, 16))


@pytest.mark.parametrize("klen", (16, 32))
def test_multikey_and_chain_kernels_match_plain_versions(dev, klen):
    from micro_aes_tpu_torch.core.bitslice import key_planes_batch
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops.chain import gcm_chain_fused_plain, gcm_chain_fused_raw
    from micro_aes_tpu_torch.ops.multikey import (
        ctrw_fused_multikey,
        ctrw_fused_multikey_plain,
        mk_window_words,
    )

    rng = np.random.default_rng(100 + klen)
    b, wm = 37, mk_window_words(300)
    keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)]
    kp_stack = key_planes_batch(torch.from_numpy(stack_round_keys(keys)).to(dev)).reshape(-1, 1)
    ctr, pt = _words(rng, dev, b * wm, 128), _words(rng, dev, b * wm, 128)
    for decrypt in (False, True):
        assert torch.equal(ctrw_fused_multikey(kp_stack, ctr, pt, b, decrypt),
                           ctrw_fused_multikey_plain(kp_stack, ctr, pt, b, decrypt))
    ops = _chain_operands(rng, dev, klen, 96, 5)
    for decrypt in (False, True):
        got = gcm_chain_fused_raw(*ops, decrypt=decrypt)
        want = gcm_chain_fused_plain(*ops, decrypt=decrypt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


def test_batch_entry_points_on_cuda_match_cpu(dev):
    from micro_aes_tpu_torch.modes import seal_batch

    rng = np.random.default_rng(9)
    lens = [0, 16, 48, 160, 320, 4096]  # fast path: whole blocks
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in lens]
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes() for _ in lens]
    aads = [rng.integers(0, 256, (7 * i) % 29, dtype=np.uint8).tobytes() for i in range(len(lens))]
    pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    got = seal_batch.gcm_seal_batch(keys, nonces, aads, pts, device=dev)
    assert got == seal_batch.gcm_seal_batch(keys, nonces, aads, pts, device="cpu")
    assert seal_batch.gcm_open_batch(keys, nonces, aads, got, device=dev) == pts
    # ragged: mixed key sizes, 8- and 60-byte nonces, partial blocks (K9)
    klens, nlens, plens = (16, 24, 32, 16), (8, 60, 12, 12), (0, 17, 100, 1000)
    keys = [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in klens]
    nonces = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in nlens]
    pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in plens]
    aads = aads[:4]
    got = seal_batch.gcm_seal_batch(keys, nonces, aads, pts, device=dev)
    assert got == seal_batch.gcm_seal_batch(keys, nonces, aads, pts, device="cpu")
    assert seal_batch.gcm_open_batch(keys, nonces, aads, got, device=dev) == pts


@pytest.mark.parametrize("klen", (16, 32))
def test_siv_kernels_match_plain_versions(dev, klen):
    """K4, K5 and K5-open (and the transposed K4/K5 wrappers) against their
    plain versions: a random base in every lane, and a counter that wraps
    at row w // 2, with a ragged last block of rows."""
    from micro_aes_tpu_torch.modes import siv_seal
    from micro_aes_tpu_torch.ops import siv_kernels as sk

    rng = np.random.default_rng(200 + klen)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    _, kp, tables = siv_seal._siv_key_setup(key, bytes(12), dev)
    kpf, w1p, w = kp.reshape(-1, 1), tables[5], 300
    ghm, x = _words(rng, dev, 1, w), _words(rng, dev, w, 128)
    basew = _words(rng, dev, 1, 128)
    wrap = basew.clone()
    wrap[0, 0::4] = -32 * (w // 2)
    assert torch.equal(sk.ghash1_fused(ghm, w1p, x), sk.ghash1_fused_plain(ghm, w1p, x))
    for base in (basew, wrap):
        assert torch.equal(sk.siv_ctrw_fused(kpf, base, x), sk.siv_ctrw_fused_plain(kpf, base, x))
        got = sk.siv_open_fused(kpf, base, ghm, w1p, x)
        want = sk.siv_open_fused_plain(kpf, base, ghm, w1p, x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    x_t = x.T.contiguous()
    assert torch.equal(sk.ghash1_fused_t(ghm, w1p, x_t), sk.ghash1_fused_plain(ghm, w1p, x))
    assert torch.equal(sk.siv_ctrw_fused_t(kpf, basew, x_t),
                       sk.siv_ctrw_fused_plain(kpf, basew, x).T)
    torch.cuda.synchronize()


@pytest.mark.parametrize("klen,nblocks", [(16, 1), (32, 4000)])
def test_gcm_siv_entry_points_on_cuda_match_cpu(dev, klen, nblocks):
    import micro_aes_tpu_torch as aes

    rng = np.random.default_rng(300 + nblocks)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    nonce = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    pt = rng.integers(0, 256, 16 * nblocks, dtype=np.uint8).tobytes()
    blob = aes.gcm_siv_seal(key, nonce, pt, device=dev)
    assert blob == aes.gcm_siv_seal(key, nonce, pt, device="cpu")
    assert aes.gcm_siv_open(key, nonce, blob, device=dev) == pt
    aad, short = b"header", pt[:37]
    sealed = aes.gcm_siv_encrypt(key, nonce, aad, short, device=dev)
    assert sealed == aes.gcm_siv_encrypt(key, nonce, aad, short, device="cpu")
    assert aes.gcm_siv_decrypt(key, nonce, aad, sealed, device=dev) == short


@pytest.mark.parametrize("klen", (16, 32))
def test_xex_kernels_match_plain_versions(dev, klen):
    """K8, K6 and K7 against their plain versions in both directions: a
    random base in every lane (K6), random lane words and an L_b table of
    12 rows of which 11 are read (K7), with a ragged last block of rows."""
    from micro_aes_tpu_torch.modes import seal
    from micro_aes_tpu_torch.ops import xex_kernels as xk

    rng = np.random.default_rng(400 + klen)
    key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    kp, _ = seal.gcm_key_setup(key, device=dev)
    kpf, w = kp.reshape(-1, 1), 300
    x, y = _words(rng, dev, w, 128), _words(rng, dev, w, 128)
    d0l, lbl = _words(rng, dev, 1, 128), _words(rng, dev, 12, 128)
    for decrypt in (False, True):
        assert torch.equal(xk.ctrw_fused(kpf, y, x, decrypt), xk.ctrw_fused_plain(kpf, y, x, decrypt))
        assert torch.equal(xk.xex_fused(kpf, y, x, decrypt), xk.xex_fused_plain(kpf, y, x, decrypt))
        assert torch.equal(xk.ocb_fused(kpf, d0l, lbl, x, 11, decrypt),
                           xk.ocb_fused_plain(kpf, d0l, lbl, x, 11, decrypt))
    torch.cuda.synchronize()


@pytest.mark.parametrize("sector,klen", [(512, 64), (4096, 32), (528, 64)])
def test_xts_sectors_and_ocb_on_cuda_match_cpu(dev, sector, klen):
    import micro_aes_tpu_torch as aes

    rng = np.random.default_rng(500 + sector)
    keys = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, 5 * sector, dtype=np.uint8).tobytes()
    sids = [7, 0, 2**40 + 17, 2**64 + 3, rng.integers(0, 256, 16, dtype=np.uint8).tobytes()]
    out = aes.xts_seal_sectors(keys, sids, data, sector, device=dev)
    assert out == aes.xts_seal_sectors(keys, sids, data, sector, device="cpu")
    assert aes.xts_open_sectors(keys, sids, out, sector, device=dev) == data
    key, nonce, aad = keys[:16], keys[16:28], data[:37]
    blob = aes.ocb_seal(key, nonce, aad, data + b"tail", device=dev)
    assert blob == aes.ocb_seal(key, nonce, aad, data + b"tail", device="cpu")
    assert aes.ocb_open(key, nonce, aad, blob, device=dev) == data + b"tail"


@pytest.mark.parametrize("b", (64, 4096))
def test_chain_kernels_match_plain_versions(dev, b):
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    rng = np.random.default_rng(600 + b)
    nb = 5

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    for klen in (16, 32):
        keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)]
        kpw = u32_tensor(key_planes_packed(stack_round_keys(keys)), dev)
        ivs, blocks = u8(b, 16), u8(b, nb, 16)
        nv = rng.integers(0, nb + 1, b).astype(np.int32)
        nv[:2] = (0, nb)
        nvalid = torch.from_numpy(nv).to(dev)
        for kind in ("cbc", "cfb"):
            assert torch.equal(ck.chain_packed_fused(kind, kpw, ivs, blocks),
                               ck.chain_packed_fused_plain(kind, kpw, ivs, blocks))
        assert torch.equal(ck.ofb_packed_fused(kpw, ivs, nb), ck.ofb_packed_fused_plain(kpw, ivs, nb))
        assert torch.equal(ck.cbcmac_packed_fused(kpw, ivs, blocks, nvalid),
                           ck.cbcmac_packed_fused_plain(kpw, ivs, blocks, nvalid))
    torch.cuda.synchronize()


def test_chain_modes_on_cuda_match_cpu(dev):
    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import bulk, chain_bulk

    rng = np.random.default_rng(700)
    lens = [0, 1, 15, 16, 17, 33, 100, 700]
    keys = [rng.integers(0, 256, (16, 24, 32)[i % 3], dtype=np.uint8).tobytes()
            for i in range(len(lens))]
    ivs = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in lens]
    pts = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    for fn in (chain_bulk.cfb_encrypt_batch, chain_bulk.ofb_xcrypt_batch, chain_bulk.cfb_decrypt_batch,
               chain_bulk.ctr_xcrypt_batch):
        assert fn(keys, ivs, pts, device=dev) == fn(keys, ivs, pts, device="cpu")
    assert bulk.cmac_batch(keys, pts, device=dev) == bulk.cmac_batch(keys, pts, device="cpu")
    long_keys, long_ivs, long_pts = keys[3:], ivs[3:], pts[3:]
    ct = chain_bulk.cbc_encrypt_batch(long_keys, long_ivs, long_pts, device=dev)
    assert ct == chain_bulk.cbc_encrypt_batch(long_keys, long_ivs, long_pts, device="cpu")
    assert chain_bulk.cbc_decrypt_batch(long_keys, long_ivs, ct, device=dev) == long_pts
    for i in (3, 6, 7):
        k, iv, pt = keys[i], ivs[i], pts[i]
        for enc, dec in ((aes.cbc_encrypt, aes.cbc_decrypt), (aes.cfb_encrypt, aes.cfb_decrypt),
                         (aes.ofb_encrypt, aes.ofb_decrypt)):
            c = enc(k, iv, pt, device=dev)
            assert c == enc(k, iv, pt, device="cpu")
            assert dec(k, iv, c, device=dev) == pt
        assert aes.cmac(k, pt, device=dev) == aes.cmac(k, pt, device="cpu")
        assert aes.ecb_encrypt(k, pt, 1, device=dev) == aes.ecb_encrypt(k, pt, 1, device="cpu")


@pytest.mark.parametrize("b", (64, 2048))
def test_aead_chain_kernels_match_plain_versions(dev, b):
    """K11 (CCM and EAX, both directions) and K12 (seal and open) against
    their plain versions, a key per message, mixed nvalid, counter bases
    that carry into byte 9."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    rng = np.random.default_rng(800 + b)
    nb = 5

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def lane_keys(klen):
        keys = [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)]
        return u32_tensor(key_planes_packed(stack_round_keys(keys)), dev)

    c0, init, tail, lastadd, prevadd, blocks = (u8(b, 16), u8(b, 16), u8(b, 16), u8(b, 16),
                                                u8(b, 16), u8(b, nb, 16))
    c0[0, 9:] = 0xFF
    c0[1, 12:] = 0xFF
    c0[2, 9:] = 0xFF
    c0[2, 15] = 0xFE
    nv = rng.integers(0, nb + 1, b).astype(np.int32)
    nv[:3] = (0, 1, nb)
    nvalid = torch.from_numpy(nv).to(dev)
    for klen in (16, 32):
        kpw = lane_keys(klen)
        for kind in ("ccm", "eax"):
            for decrypt in (False, True):
                args = (kind, kpw, c0, init, blocks, nvalid, tail, lastadd, decrypt)
                got, want = ak.aead_chain_fused(*args), ak.aead_chain_fused_plain(*args)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        nvs = nvalid.clamp(min=1)  # S2V folds at least one block
        seal = (kpw, lane_keys(klen), init, blocks, nvs, tail, lastadd, prevadd)
        got, want = ak.siv_seal_chain_fused(*seal), ak.siv_seal_chain_fused_plain(*seal)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        opened = seal[:2] + (c0,) + seal[2:]
        got, want = ak.siv_open_chain_fused(*opened), ak.siv_open_chain_fused_plain(*opened)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


def test_aead_batches_on_cuda_match_cpu(dev):
    """The CCM, EAX and SIV batches and per-message modes on CUDA against the
    same calls on the CPU: mixed key sizes, empty and ragged messages, a
    tampered message."""
    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import bulk

    rng = np.random.default_rng(900)
    lens = [0, 1, 15, 16, 17, 33, 100, 700]

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    keys = [rand((16, 24, 32)[i % 3]) for i in range(len(lens))]
    nonces, aads, pts = [rand(12) for _ in lens], [rand(i % 3 * 20) for i in range(len(lens))], \
        [rand(n) for n in lens]
    for seal, open_ in ((bulk.ccm_encrypt_batch, bulk.ccm_decrypt_batch),
                        (bulk.eax_encrypt_batch, bulk.eax_decrypt_batch)):
        ct = seal(keys, nonces, aads, pts, device=dev)
        assert ct == seal(keys, nonces, aads, pts, device="cpu")
        ct[4] = bytes([ct[4][0] ^ 1]) + ct[4][1:]
        assert open_(keys, nonces, aads, ct, device=dev) == \
            [None if i == 4 else p for i, p in enumerate(pts)]
    skeys = [k + rand(len(k)) for k in keys]
    sealed = bulk.siv_encrypt_batch(skeys, aads, pts, device=dev)
    assert sealed == bulk.siv_encrypt_batch(skeys, aads, pts, device="cpu")
    assert bulk.siv_decrypt_batch(skeys, [s[0] for s in sealed], aads, [s[1] for s in sealed],
                                  device=dev) == pts
    for i in (0, 5, 7):
        assert aes.ccm_encrypt(keys[i], nonces[i], aads[i], pts[i], device=dev) == \
            aes.ccm_encrypt(keys[i], nonces[i], aads[i], pts[i], device="cpu")
        assert aes.eax_encrypt(keys[i], nonces[i], aads[i], pts[i], device=dev) == \
            aes.eax_encrypt(keys[i], nonces[i], aads[i], pts[i], device="cpu")
        assert aes.eaxp_encrypt(keys[i], aads[i], pts[i], device=dev) == \
            aes.eaxp_encrypt(keys[i], aads[i], pts[i], device="cpu")
        assert aes.siv_encrypt(skeys[i], aads[i], pts[i], device=dev) == sealed[i]
