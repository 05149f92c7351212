"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version at small shapes (bit-exact), and the bulk AES-GCM / CTR,
multi-key batch GCM, GCM-SIV, XTS sector, OCB, chain, CCM/EAX/SIV, KW,
Poly1305 and FPE batch entry points on CUDA against the same calls on the
CPU, and the compat surface on the main.c answers.

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


@pytest.mark.parametrize("b", (64, 1024))
def test_kw_wide_and_ctr_kernels_match_plain_versions(dev, b):
    """K16 (wrap and unwrap, natural map; the wide map where wide_ok), K14
    (CBC, CFB, OFB, where wide_ok; also against K13) and K15 (bases that
    carry into byte 9) against their plain versions, a key per message."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed, wide_ok, wide_perm
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops import kw_kernels as kk
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    rng = np.random.default_rng(1000 + b)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    for klen in (16, 32):
        rks = stack_round_keys([rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
                                for _ in range(b)])
        kpw = u32_tensor(key_planes_packed(rks), dev)
        kpw_w = u32_tensor(key_planes_packed(rks[wide_perm(b)]), dev) if wide_ok(b) else None
        for n in (2, 5):
            secrets = u8(b, n, 8)
            wrapped = kk.kw_packed(kpw, secrets)
            assert torch.equal(wrapped, kk.kw_packed_plain(kpw, secrets))
            back = kk.kw_packed(kpw, wrapped, unwrap=True)
            assert torch.equal(back, kk.kw_packed_plain(kpw, wrapped, unwrap=True))
            assert torch.equal(back[:, 1:], secrets) and bool((back[:, 0] == 0xA6).all())
            if kpw_w is not None:
                assert torch.equal(kk.kw_packed_fused(kpw_w, secrets), wrapped)
                assert torch.equal(kk.kw_packed_fused(kpw_w, wrapped, unwrap=True), back)
        nb = 5
        ivs, blocks = u8(b, 16), u8(b, nb, 16)
        if kpw_w is not None:
            for kind in ("cbc", "cfb"):
                got = ck.chain_packed_fused_wide(kind, kpw_w, ivs, blocks)
                assert torch.equal(got, ck.chain_packed_fused_wide_plain(kind, kpw_w, ivs, blocks))
                assert torch.equal(got, ck.chain_packed_fused(kind, kpw, ivs, blocks))
            got = ck.ofb_packed_fused_wide(kpw_w, ivs, nb)
            assert torch.equal(got, ck.ofb_packed_fused_wide_plain(kpw_w, ivs, nb))
            assert torch.equal(got, ck.ofb_packed_fused(kpw, ivs, nb))
        c0 = u8(b, 16)
        c0[0, 9:] = 0xFF
        c0[1, 12:] = 0xFF
        c0[2, 9:] = 0xFF
        c0[2, 15] = 0xFE
        for nbc in (1, 5, 70):
            data = u8(b, nbc, 16)
            assert torch.equal(ak.ctr_packed_fused(kpw, c0, data),
                               ak.ctr_packed_fused_plain(kpw, c0, data))
    torch.cuda.synchronize()


def test_ragged_entries_match_plain_versions(dev):
    """K13's chain_packed_ragged (CBC, CFB, OFB) and K16's kw_wheel_ragged
    (wrap, then unwrap) in one launch each against their plain versions:
    keys of 16/24/32 bytes, 2, 3 and 40 steps, a run of 33 messages."""
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.ops import kw_kernels as kk
    from micro_aes_tpu_torch.ops.ragged import layout_key_planes, ragged_layout

    rng = np.random.default_rng(1200)
    keys = [rng.integers(0, 256, (16, 24, 32)[i % 3], dtype=np.uint8).tobytes()
            for i in range(60)] + [bytes(range(32))] * 33
    steps = [(2, 3, 40)[(i // 3) % 3] for i in range(60)] + [3] * 33
    rounds = [len(k) // 4 + 6 for k in keys]
    lay = ragged_layout(steps, rounds, [16 * n for n in steps])
    kpw = layout_key_planes(keys, lay, dev)
    ivs = torch.from_numpy(rng.integers(0, 256, (len(keys), 16), dtype=np.uint8)).to(dev)
    blocks = torch.from_numpy(rng.integers(0, 256, lay.nbytes, dtype=np.uint8)).to(dev)
    for kind in ("cbc", "cfb", "ofb"):
        args = (kind, kpw, lay.desc, ivs) + ((None, lay.nbytes) if kind == "ofb" else (blocks,))
        before = ck.chain_packed_ragged.launches
        assert torch.equal(ck.chain_packed_ragged(*args), ck.chain_packed_ragged_plain(*args))
        assert ck.chain_packed_ragged.launches == before + 1
    lay = ragged_layout(steps, rounds, [8 * (n + 1) for n in steps])
    kpw = layout_key_planes(keys, lay, dev)
    data = torch.from_numpy(rng.integers(0, 256, lay.nbytes, dtype=np.uint8)).to(dev)
    wrapped = kk.kw_wheel_ragged(kpw, lay.desc, data)
    assert torch.equal(wrapped, kk.kw_wheel_ragged_plain(kpw, lay.desc, data))
    back = kk.kw_wheel_ragged(kpw, lay.desc, wrapped, unwrap=True)
    assert torch.equal(back, kk.kw_wheel_ragged_plain(kpw, lay.desc, wrapped, unwrap=True))
    starts = torch.from_numpy(lay.offsets).to(dev)
    assert bool((back[starts[:, None] + torch.arange(8, device=dev)] == 0xA6).all())
    torch.cuda.synchronize()


def test_kw_on_cuda_matches_cpu(dev):
    """key_wrap/key_unwrap and the KW batches on CUDA against the CPU: mixed
    KEK sizes, ragged secrets and a group of 1,024, all in one launch each
    way, a tampered member."""
    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import bulk
    from micro_aes_tpu_torch.testing import kat

    rng = np.random.default_rng(1100)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    for klen, want in kat.KW_VECTORS:
        assert aes.key_wrap(kat.KW_KEK[:klen], kat.KW_SECRET[:klen], device=dev) == want
        assert aes.key_unwrap(kat.KW_KEK[:klen], want, device=dev) == kat.KW_SECRET[:klen]
    keks = [rand((16, 24, 32)[i % 3]) for i in range(40)] + [rand(16) for _ in range(1024)]
    secrets = [rand(16 + 8 * (i % 7)) for i in range(40)] + [rand(72) for _ in range(1024)]
    wrapped = bulk.key_wrap_batch(keks, secrets, device=dev)
    assert wrapped == bulk.key_wrap_batch(keks, secrets, device="cpu")
    wrapped[3] = bytes([wrapped[3][0] ^ 1]) + wrapped[3][1:]
    assert bulk.key_unwrap_batch(keks, wrapped, device=dev) == \
        [None if i == 3 else s for i, s in enumerate(secrets)]


def test_multikey_entries_match_plain_versions(dev):
    """K9's ragged entry (one launch each way) against its plain version:
    keys of 16/24/32 bytes, 0 to 70 blocks, empty messages, warps of many
    short messages (each lane's own round key) and of a few long ones (the
    round keys staged in shared memory); and its uniform cipher-and-xor on
    round keys against the plain version of the JAX contract."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_batch
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import multikey as mk

    rng = np.random.default_rng(1300)
    keys = [rng.integers(0, 256, (16, 24, 32)[i % 3], dtype=np.uint8).tobytes()
            for i in range(150)]
    nb = [int(x) for x in rng.integers(0, 71, 150)]
    nb[:12] = [0, 1, 2, 3, 0, 31, 32, 33, 64, 65, 70, 0]
    nb[100:] = [int(x) for x in rng.integers(300, 1100, 50)]  # 10-35 rows each
    lay = mk.multikey_layout(keys, nb)
    rks = mk.layout_round_keys(keys, dev)
    blocks = torch.from_numpy(rng.integers(0, 256, (lay.nblocks, 16), dtype=np.uint8)).to(dev)
    for decrypt in (False, True):
        before = mk.cipher_blocks_ragged.launches
        got = mk.cipher_blocks_ragged(rks, lay.desc, blocks, decrypt)
        assert torch.equal(got, mk.cipher_blocks_ragged_plain(rks, lay.desc, blocks, decrypt))
        assert mk.cipher_blocks_ragged.launches == before + 1
    back = mk.cipher_blocks_ragged(rks, lay.desc, got)
    assert torch.equal(back, blocks)
    for klen, b, wm in ((16, 37, 8), (32, 5, 40)):
        rk = torch.from_numpy(stack_round_keys(
            [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)])).to(dev)
        ctr, pt = _words(rng, dev, b * wm, 128), _words(rng, dev, b * wm, 128)
        kp = key_planes_batch(rk).reshape(-1, 1)
        for decrypt in (False, True):
            assert torch.equal(mk.ctrw_multikey_rks(rk, ctr, pt, b, decrypt),
                               mk.ctrw_fused_multikey_plain(kp, ctr, pt, b, decrypt))
    torch.cuda.synchronize()


def test_mac_constants_and_keystream_options_match_plain_versions(dev):
    """K13's masked CBC-MAC with the one-pass AEAD chains' last-step
    constants (tail and lastadd, with and without prevadd) and K15 with and
    without CCM's whitener against their plain versions, a key per message,
    0 to nb valid blocks."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.ops import chain_kernels as ck
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    rng = np.random.default_rng(1400)
    b = 96

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    for klen in (16, 24, 32):
        kpw = u32_tensor(key_planes_packed(stack_round_keys(
            [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)])), dev)
        init, tail, lastadd, prevadd = (u8(b, 16) for _ in range(4))
        for nb in (0, 1, 5, 40):
            blocks = u8(b, nb, 16)
            nvalid = torch.from_numpy(rng.integers(0, nb + 1, b).astype(np.int32)).to(dev)
            for consts in ((tail, lastadd, None), (tail, lastadd, prevadd)):
                assert torch.equal(ck.cbcmac_packed_fused(kpw, init, blocks, nvalid, *consts),
                                   ck.cbcmac_packed_fused_plain(kpw, init, blocks, nvalid,
                                                                *consts))
            c0 = u8(b, 16)
            c0[0, 9:] = 0xFF
            c0[1, 8:] = 0xFF
            for whiten in (True, False):
                got = ak.ctr_packed_fused(kpw, c0, blocks, whiten)
                want = ak.ctr_packed_fused_plain(kpw, c0, blocks, whiten)
                for g, w in zip(got if whiten else (got,), want if whiten else (want,)):
                    assert torch.equal(g, w)
    torch.cuda.synchronize()


def _ctr_packed_cols(kpw, c0, blocks, whiten, cols):
    """K15 with its thread layout forced: `cols` state columns a thread (the
    C entry's choice when 0)."""
    from micro_aes_tpu_torch.ops import _build

    out = torch.empty_like(blocks)
    wh = torch.empty_like(c0) if whiten else None
    err = _build.load().micro_aes_ctr_packed(
        kpw.data_ptr(), c0.data_ptr(), blocks.data_ptr(), out.data_ptr(),
        None if wh is None else wh.data_ptr(), kpw.shape[0] - 1, kpw.shape[3], blocks.shape[1],
        cols, torch.cuda.current_stream(blocks.device).cuda_stream)
    _build.check_launch("ctr_packed_fused", err)
    return (out, wh) if whiten else out


def k15_edge_bases(c0):
    """Counter bases at K15's edges: bytes 9..15 all 0xFF (the window wraps
    to 0 at step 1, its carry out of byte 9 dropped and byte 8 kept), the
    same under byte 8 = 0xFF, bytes 12..15 0xFF (a carry into byte 11 at
    step 1), and a carry through bytes 9..11 at step 16."""
    c0[0, 9:] = 0xFF
    c0[1, 8:] = 0xFF
    c0[2, 12:] = 0xFF
    c0[3, 9:] = 0xFF
    c0[3, 15] = 0xF0
    return c0


@pytest.mark.parametrize("cols", (0, 4, 2, 1))
def test_ctr_packed_edge_cases_match_plain_version(dev, cols):
    """K15 in each thread layout (0: the one its entry picks) against its
    plain version: counter bases at the edges of the 56-bit window, CCM's
    whitener, nb = 1, nb that ends inside a block's steps, one word (W = 1),
    keys of 16/24/32 bytes."""
    from micro_aes_tpu_torch.core.bitslice import key_planes_packed
    from micro_aes_tpu_torch.modes.bulk import stack_round_keys
    from micro_aes_tpu_torch.ops import aead_kernels as ak
    from micro_aes_tpu_torch.utils.bytesio import u32_tensor

    rng = np.random.default_rng(1500 + cols)

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    for klen in (16, 24, 32):
        for b, nb in ((32, 1), (32, 33), (64, 130), (96, 257)):
            kpw = u32_tensor(key_planes_packed(stack_round_keys(
                [rng.integers(0, 256, klen, dtype=np.uint8).tobytes() for _ in range(b)])), dev)
            c0, blocks = k15_edge_bases(u8(b, 16)), u8(b, nb, 16)
            for whiten in (False, True):
                if cols:
                    got = _ctr_packed_cols(kpw, c0, blocks, whiten, cols)
                else:
                    got = ak.ctr_packed_fused(kpw, c0, blocks, whiten)
                want = ak.ctr_packed_fused_plain(kpw, c0, blocks, whiten)
                for g, w in zip(got if whiten else (got,), want if whiten else (want,)):
                    assert torch.equal(g, w), (klen, b, nb, whiten)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", (1, 33, 257))
def test_seal_fused_edge_cases_match_plain_version(dev, w):
    """K1 (seal and open) against its plain version where W is not a
    multiple of 256 or of 32 and ghmask rows are partial (none, the low
    half, one block, all), AES-128 and AES-256."""
    rng = np.random.default_rng(1600 + w)
    for klen in (16, 32):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, tables = seal.gcm_key_setup(key, device=dev)
        kpf = kp.reshape(-1, 1)
        j0 = torch.from_numpy(rng.integers(0, 256, 16, dtype=np.uint8)).to(dev)
        j0c, lohi = j0_planes(j0), lohi_words(j0, w, -1)
        ghm, pt = _words(rng, dev, 1, w), _words(rng, dev, w, 128)
        for i, m in enumerate((0, 0x0000FFFF, -2**31, -1)):
            ghm[0, (i * 7) % w] = m
        for opening in (False, True):
            got = seal_fused(kpf, j0c, lohi, ghm, tables[5], pt, opening)
            want = seal_fused_plain(kpf, j0c, lohi, ghm, tables[5], pt, opening)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (klen, opening)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", (1, 129))
def test_xex_fused_edge_cases_match_plain_version(dev, w):
    """K6 (both directions) against its plain version at the edges of its
    word-domain offsets: bases all-ones, and word 3 = 0x80000000 or
    0xFFFFFFFF in every lane (every block jj > 0 overflows; for jj > 25 the
    fold reaches word 1), where W is not a multiple of the block's rows,
    AES-128 and AES-256."""
    from micro_aes_tpu_torch.ops import xex_kernels as xk

    rng = np.random.default_rng(1700 + w)
    for klen in (16, 32):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, _ = seal.gcm_key_setup(key, device=dev)
        kpf, x = kp.reshape(-1, 1), _words(rng, dev, w, 128)
        for top in (None, -2**31, -1):
            base = _words(rng, dev, w, 128)
            if top is None:
                base.fill_(-1)
            else:
                base[:, 3::4] = top
            for decrypt in (False, True):
                assert torch.equal(xk.xex_fused(kpf, base, x, decrypt),
                                   xk.xex_fused_plain(kpf, base, x, decrypt)), (klen, top, decrypt)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", (1, 127, 128, 129, 300))
def test_ocb_fused_edge_cases_match_plain_version(dev, w):
    """K7 (both directions) against its plain version where W is under, at
    and over the block's 128 rows (its offset table's walk, and block 31 of
    a block's last row) and nbits runs from 0 to 32, random lane words for
    D_0 and L_b, AES-128 and AES-256."""
    from micro_aes_tpu_torch.ops import xex_kernels as xk

    rng = np.random.default_rng(1900 + w)
    for klen in (16, 32):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, _ = seal.gcm_key_setup(key, device=dev)
        kpf, x = kp.reshape(-1, 1), _words(rng, dev, w, 128)
        d0l, lbl = _words(rng, dev, 1, 128), _words(rng, dev, 32, 128)
        for nbits in (0, 1, 5, 6, 12, 21, 32):
            for decrypt in (False, True):
                assert torch.equal(xk.ocb_fused(kpf, d0l, lbl, x, nbits, decrypt),
                                   xk.ocb_fused_plain(kpf, d0l, lbl, x, nbits, decrypt)), \
                    (klen, nbits, decrypt)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", (1, 31, 33, 257, 300))
def test_ghash1_fused_edge_cases_match_plain_version(dev, w):
    """K4 (and K4 on the transposed stream) against its plain version where
    W is not a multiple of 256 or of 32 and ghmask rows are partial (none,
    the low half, one block, all)."""
    from micro_aes_tpu_torch.modes import siv_seal
    from micro_aes_tpu_torch.ops import siv_kernels as sk

    rng = np.random.default_rng(2000 + w)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    _, _, tables = siv_seal._siv_key_setup(key, bytes(12), dev)
    w1p = tables[5]
    ghm, x = _words(rng, dev, 1, w), _words(rng, dev, w, 128)
    for i, m in enumerate((0, 0x0000FFFF, -2**31, -1)):
        ghm[0, (i * 7) % w] = m
    want = sk.ghash1_fused_plain(ghm, w1p, x)
    assert torch.equal(sk.ghash1_fused(ghm, w1p, x), want)
    assert torch.equal(sk.ghash1_fused_t(ghm, w1p, x.T.contiguous()), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", (1, 33, 257))
def test_siv_open_fused_edge_cases_match_plain_version(dev, w):
    """K5-open against its plain version where W is not a multiple of 256
    or of 32, ghmask rows are partial (none, the low half, one block, all)
    and the counter base wraps inside row W // 2, AES-128 and AES-256."""
    from micro_aes_tpu_torch.modes import siv_seal
    from micro_aes_tpu_torch.ops import siv_kernels as sk

    rng = np.random.default_rng(1800 + w)
    for klen in (16, 32):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        _, kp, tables = siv_seal._siv_key_setup(key, bytes(12), dev)
        kpf, w1p = kp.reshape(-1, 1), tables[5]
        ghm, x, basew = _words(rng, dev, 1, w), _words(rng, dev, w, 128), _words(rng, dev, 1, 128)
        for i, m in enumerate((0, 0x0000FFFF, -2**31, -1)):
            ghm[0, (i * 7) % w] = m
        wrap = basew.clone()
        wrap[0, 0::4] = -32 * (w // 2) - 5
        for base in (basew, wrap):
            got = sk.siv_open_fused(kpf, base, ghm, w1p, x)
            want = sk.siv_open_fused_plain(kpf, base, ghm, w1p, x)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), klen
    torch.cuda.synchronize()


@pytest.mark.parametrize("w", (1, 127, 128, 129, 300))
def test_ctr_xor_body_edge_cases_match_plain_versions(dev, w):
    """K3 and K5 (one body: the input copied under the cipher, the keystream
    XORed in the word domain) against their plain versions where the last
    block of 128 rows is partly full, AES-128 and AES-256; K5 and K5-open
    with bases of random lanes, a word 0 that wraps inside row W // 2 and
    lanes where basew[4j] + j itself wraps for j >= 7 (basew[4j] =
    2^32 - 1 - j mod 7); K3 with a counter that wraps lo into hi."""
    from micro_aes_tpu_torch.modes import siv_seal
    from micro_aes_tpu_torch.ops import siv_kernels as sk

    rng = np.random.default_rng(2100 + w)
    for klen in (16, 32):
        key = rng.integers(0, 256, klen, dtype=np.uint8).tobytes()
        kp, _ = seal.gcm_key_setup(key, device=dev)
        kpf, x = kp.reshape(-1, 1), _words(rng, dev, w, 128)
        j0 = torch.from_numpy(rng.integers(0, 256, 16, dtype=np.uint8)).to(dev)
        for wraps in (False, True):
            if wraps:
                j0[12:16] = torch.tensor([0xFF, 0xFF, 0xFF, 0xE1], dtype=torch.uint8)
            j0c, lohi = j0_planes(j0), lohi_words(j0, w, -1)
            assert torch.equal(ctr_fused(kpf, j0c, lohi, x),
                               ctr_fused_plain(kpf, j0c, lohi, x)), (klen, wraps)
        _, skp, tables = siv_seal._siv_key_setup(key, bytes(12), dev)
        skpf, w1p, ghm = skp.reshape(-1, 1), tables[5], _words(rng, dev, 1, w)
        lanes = _words(rng, dev, 1, 128)
        wrap = lanes.clone()
        wrap[0, 0::4] = -32 * (w // 2) - 5
        lane_wrap = lanes.clone()
        lane_wrap[0, 0::4] = -1 - torch.arange(32, device=dev, dtype=torch.int32) % 7
        for name, base in (("lanes", lanes), ("wrap", wrap), ("lane_wrap", lane_wrap)):
            assert torch.equal(sk.siv_ctrw_fused(skpf, base, x),
                               sk.siv_ctrw_fused_plain(skpf, base, x)), (klen, name)
            assert torch.equal(sk.siv_ctrw_fused_t(skpf, base, x.T.contiguous()),
                               sk.siv_ctrw_fused_plain(skpf, base, x).T), (klen, name)
            got = sk.siv_open_fused(skpf, base, ghm, w1p, x)
            want = sk.siv_open_fused_plain(skpf, base, ghm, w1p, x)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (klen, name)
    torch.cuda.synchronize()


def test_poly1305_bulk_on_cuda_matches_cpu(dev):
    """The Poly1305 fold (float64 products on the card) at 1 MiB + 5 B, and
    the routed entry point at the threshold, against the CPU."""
    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.modes import poly1305
    from micro_aes_tpu_torch.testing import kat

    rng = np.random.default_rng(1500)
    keys, nonce = rng.integers(0, 256, 48, dtype=np.uint8).tobytes(), bytes(range(16))
    for n in ((1 << 20) + 5, poly1305._BULK_THRESHOLD + 7):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = poly1305.poly1305_aes_bulk(keys, nonce, data, device="cpu")
        assert poly1305.poly1305_aes_bulk(keys, nonce, data, device=dev) == want, n
        assert aes.poly1305_aes(keys, nonce, data, device=dev) == want, n
    assert aes.poly1305_aes(kat.MAIN_KEY, kat.MAIN_IV, kat.MAIN_PLAINTEXT,
                            device=dev) == kat.POLY1305_128


@pytest.mark.parametrize("method, tweak", (("ff1", b"tweak123"), ("ff3-1", bytes(range(7)))))
def test_fpe_batches_on_cuda_match_cpu(dev, method, tweak):
    """fpe_encrypt_batch/fpe_decrypt_batch of 1,024 sixteen-digit tokens on
    the card (the PRF on K2) against the CPU, and the host path's FF1 PRF
    on K13."""
    import micro_aes_tpu_torch as aes
    from micro_aes_tpu_torch.fpe import device as fdev
    from micro_aes_tpu_torch.ops.chain_kernels import cbcmac_packed_fused

    rng = np.random.default_rng(1501)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    toks = ["".join(map(str, row)) for row in rng.integers(0, 10, (1024, 16))]
    before = cipher_planes.launches
    out = fdev.fpe_encrypt_batch(key, tweak, toks, "digits", method, device=dev)
    assert cipher_planes.launches > before
    assert out == fdev.fpe_encrypt_batch(key, tweak, toks, "digits", method, device="cpu")
    back = fdev.fpe_decrypt_batch(key, tweak, out, "digits", method, device=dev)
    assert back == toks
    macs = cbcmac_packed_fused.launches
    assert aes.fpe_encrypt(key, tweak, toks[0], "digits", method, device=dev) == out[0]
    assert cbcmac_packed_fused.launches - macs == (10 if method == "ff1" else 0)


def test_compat_on_cuda_gives_main_c_answers(dev):
    from micro_aes_tpu_torch import compat
    from micro_aes_tpu_torch.testing import kat

    key, iv, aad, pt, ok = kat.MAIN_KEY[:16], kat.MAIN_IV, kat.MAIN_AAD, kat.MAIN_PLAINTEXT, 0
    assert compat.AES_Cipher(kat.FIPS_KEY128, "E", kat.FIPS_PT, device=dev) == kat.FIPS_CT128
    assert compat.AES_ECB_encrypt(key, pt, device=dev) == kat.ECB128
    assert compat.AES_CBC_encrypt(key, iv, pt, device=dev) == (ok, kat.CBC128_CTS)
    assert compat.AES_CFB_encrypt(key, iv, pt, device=dev) == kat.CFB128
    assert compat.AES_OFB_encrypt(key, iv, pt, device=dev) == kat.OFB128
    assert compat.AES_CTR_encrypt(key, iv, pt, device=dev) == kat.CTR128
    assert compat.AES_GCM_decrypt(key, iv[:12], aad, kat.GCM128, device=dev) == (ok, pt)
    assert compat.AES_CCM_encrypt(key, iv[:11], aad, pt, device=dev) == kat.CCM128
    assert compat.AES_EAX_encrypt(key, iv, aad, pt, device=dev) == kat.EAX128
    assert compat.GCM_SIV_encrypt(key, iv[:12], aad, pt, device=dev) == kat.GCMSIV128
    assert compat.AES_CMAC(key, pt, device=dev) == kat.CMAC128
    assert compat.AES_Poly1305(kat.MAIN_KEY, iv, pt, device=dev) == kat.POLY1305_128
    assert compat.AES_KEY_wrap(kat.KW_KEK[:16], kat.KW_SECRET[:16], device=dev) == \
        (ok, kat.KW128)
    assert compat.AES_FPE_encrypt(key, aad, kat.FPE_PLAIN, device=dev) == \
        (ok, kat.FPE_FF1_CIPHER)
    bad = kat.GCM128[:-1] + bytes([kat.GCM128[-1] ^ 1])
    assert compat.AES_GCM_decrypt(key, iv[:12], aad, bad, device=dev) == \
        (compat.M_AUTHENTICATION_ERROR, b"")


def test_four_shards_in_process_match_gcm_seal(dev):
    """The sp-sharded GCM's per-shard body on K1 at the shard counter
    offsets (start = s*L - 1), the partials XORed on the card, against
    gcm_seal at 1 MiB with AAD."""
    from micro_aes_tpu_torch import parallel as par
    from micro_aes_tpu_torch.core.cipher import encrypt_blocks_np

    rng = np.random.default_rng(16)
    key, nonce, aad = (rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (32, 12, 40))
    n, shards = 1 << 16, 4
    l = n // shards
    pt = rng.integers(0, 256, (1, n, 16), dtype=np.uint8)
    kp, tables = seal.gcm_key_setup(key, device=dev)
    j0 = np.zeros((1, 16), np.uint8)
    j0[0, :12] = np.frombuffer(nonce, np.uint8)
    j0[0, 15] = 1
    adj = par.shard_adjust_matrices_fused(tables[3], l, shards, device=dev)
    j0_t, pt_t = torch.from_numpy(j0).to(dev), torch.from_numpy(pt).to(dev)
    before = seal_fused.launches
    outs, g = [], 0
    for s in range(shards):
        out, g_s = par.fused_shard_body(kp, tables, adj[s], j0_t, pt_t[:, s * l:(s + 1) * l], s, l)
        outs.append(out)
        g = g ^ g_s
    assert seal_fused.launches - before == shards
    acc, shift, alen = par.sharded_aad_args(key, aad, n, 1, device=dev)
    tag = par.sharded_tags(tables, g, torch.from_numpy(encrypt_blocks_np(key, j0)).to(dev),
                           acc, shift, n, alen)
    got = torch.cat(outs, 1).cpu().numpy().tobytes() + tag.cpu().numpy().tobytes()
    assert got == seal.gcm_seal(key, nonce, pt.tobytes(), aad, device=dev)


def test_seal_batch_core_on_k9_matches_plain_version(dev, monkeypatch):
    """The matrix-GHASH multi-key core with its cipher on K9's uniform entry
    against the same core on K9's plain version, on the card."""
    from micro_aes_tpu_torch.modes import seal_batch
    from micro_aes_tpu_torch.ops import multikey

    rng = np.random.default_rng(17)
    b = 64
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(b)]
    nonces = [rng.integers(0, 256, 12, dtype=np.uint8).tobytes() for _ in range(b)]
    aads = [rng.integers(0, 256, i % 20, dtype=np.uint8).tobytes() for i in range(b)]
    pts = [rng.integers(0, 256, 16 * (1 + 7 * i), dtype=np.uint8).tobytes() for i in range(b)]
    bb, wm, _, ns, front, *args = seal_batch._prep(keys, nonces, aads, pts, device=dev)
    before = multikey.ctrw_multikey_rks.launches
    got = seal_batch._seal_batch_core(*args, bb, wm)
    assert multikey.ctrw_multikey_rks.launches - before == 1
    monkeypatch.setattr(seal_batch, "ctrw_fused_multikey", multikey.ctrw_fused_multikey_plain)
    want = seal_batch._seal_batch_core(*args, bb, wm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    api = seal_batch.gcm_seal_batch(keys, nonces, aads, pts, device=dev)
    words = got[0].cpu().numpy().view(np.uint32).reshape(bb, -1)
    assert [words[i, 4 * front[i]: 4 * (front[i] + ns[i])].tobytes()
            + got[1][i].cpu().numpy().tobytes() for i in range(bb)] == api
