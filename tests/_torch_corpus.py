"""A small known-answer corpus for the conformance harness (imported by
tests/test_torch_harness.py and by chip_smoke.py; its name keeps pytest from
collecting it).

`write_corpus(root)` writes the nine suites' files that testing/rsp.py's
loaders open (GCM and CMAC at 128/192/256, CCM at 128/192/256, XTS at
128/256, GCM-SIV, Poly1305, EAX, OCB, FPE), each in the reference corpus'
own format, a few records a file.  The answers are the published ones in
micro_aes_tpu_torch.testing.kat: main.c's, the McGrew-Viega GCM cases,
RFC 8452's GCM-SIV and RFC 7253's OCB vectors.  Where no published answer
exists for a key size (CCM and CMAC at 192 and 256 bits) or a record (the
bit-granular XTS record the harness leaves out), the answer is made with
the port on the CPU, whose plain versions the CPU tests hold against the
JAX package.  Only torch and the port are imported.

With flip=True one byte of the expected answer in one record of each suite
is flipped; keys are never touched.  The answer flipped is the one the
harness compares first (the plaintext where a flipped ciphertext would
fail authentication before any compare: GCM-SIV and EAX).  The return
value maps each suite's report name to the failure-log line that names the
flipped record.
"""
from __future__ import annotations

from pathlib import Path

from micro_aes_tpu_torch.modes import ccm_encrypt, xts_encrypt
from micro_aes_tpu_torch.modes.bulk import cmac_batch
from micro_aes_tpu_torch.testing import kat

# the suites' report names, in the order the harness prints them
REPORTS = ("CCM-128", "CCM-192", "CCM-256", "CMAC-128", "CMAC-192", "CMAC-256", "EAX",
           "FPE", "GCM-128", "GCM-192", "GCM-256", "GCM-SIV", "OCB", "POLY1305",
           "XTS-128", "XTS-256")
# the report that carries each suite's flipped record
FLIPPED = {"CCM": "CCM-128", "CMAC": "CMAC-128", "EAX": "EAX", "FPE": "FPE",
           "GCM": "GCM-128", "GCMSIV": "GCM-SIV", "OCB": "OCB", "POLY1305": "POLY1305",
           "XTS": "XTS-128"}


def _flip_hex(h: str) -> str:
    """h with the low bit of its first byte flipped."""
    return f"{int(h[:2], 16) ^ 1:02x}" + h[2:]


def _flip_digits(s: str) -> str:
    """s with its first digit changed (still a digit)."""
    return str((int(s[0]) + 1) % 10) + s[1:]


def _write(path: Path, header: str, blocks: list[str]) -> None:
    path.write_text(header + "\n" + "\n".join(blocks))


def _kv(sep: str = " = ", **fields) -> str:
    return "".join(f"{k}{sep}{v}\n" for k, v in fields.items())


def _gcm(root: Path, flip: bool) -> str:
    aad = kat.AAD
    m128 = (kat.CIPHER_KEY[:16], kat.IVEC[:12], aad, kat.PLAINTEXT, kat.GCM128[:-16],
            kat.GCM128[-16:], 128)
    m256 = (kat.CIPHER_KEY, kat.IVEC[:12], aad, kat.PLAINTEXT, kat.GCM256[:-16],
            kat.GCM256[-16:], 128)
    spec = {k: [] for k in (16, 24, 32)}
    for _, key, iv, pt, ct, tag in kat.GCM_SPEC_VECTORS:
        spec[len(key)].append((key, iv, b"", pt, ct, tag, 128))
    for _, key, iv, a, pt, ct, tag in kat.GCM_SPEC_AEAD_VECTORS:
        spec[len(key)].append((key, iv, a, pt, ct, tag, 128))
    # a truncated tag: run_gcm compares Taglen / 8 bytes of it
    key, iv, a, pt, ct, tag, _ = spec[16][-1]
    spec[16].append((key, iv, a, pt, ct, tag[:12], 96))
    for klen, recs in ((128, [m128] + spec[16]), (192, spec[24]), (256, [m256] + spec[32])):
        blocks = []
        for count, (key, iv, a, pt, ct, tag, taglen) in enumerate(recs):
            ct_hex = ct.hex()
            if flip and klen == 128 and count == 0:
                ct_hex = _flip_hex(ct_hex)
            blocks.append(
                f"[Keylen = {klen}]\n[IVlen = {8 * len(iv)}]\n[PTlen = {8 * len(pt)}]\n"
                f"[AADlen = {8 * len(a)}]\n[Taglen = {taglen}]\n\n"
                + _kv(Count=count, Key=key.hex(), IV=iv.hex(), PT=pt.hex(), AAD=a.hex(),
                      CT=ct_hex, Tag=tag.hex()))
        _write(root / f"GcmEncryptExtIV{klen}.rsp",
               f"# CAVS 14.0\n# GCM Encrypt with keysize {klen} test information\n", blocks)
    return f"Count=0 Key={m128[0].hex()}"


def _ccm(root: Path, flip: bool) -> str:
    aad, pt = kat.AAD, kat.PLAINTEXT
    for klen in (128, 192, 256):
        key = kat.CIPHER_KEY[: klen // 8]
        if klen == 128:
            recs = [(11, kat.CCM128)]
        else:
            recs = [(n, ccm_encrypt(key, kat.IVEC[:n], aad, pt, n, 16, device="cpu"))
                    for n in (7, 13)]
        blocks = []
        for count, (nlen, ct) in enumerate(recs):
            ct_hex = ct.hex()
            if flip and klen == 128:
                ct_hex = _flip_hex(ct_hex)
            blocks.append(f"[Nlen = {nlen}]\n\n" + _kv(Key=key.hex(), Nonce=kat.IVEC[:nlen].hex())
                          + "\n" + _kv(Count=count, Adata=aad.hex(), Payload=pt.hex(),
                                       CT=ct_hex))
        _write(root / f"VNT{klen}.rsp",
               f"#  CAVS 11.0\n#  \"CCM-VNT\" information\n#  AES Keylen: {klen}\n\n"
               + _kv(Alen=len(aad), Plen=len(pt), Tlen=16), blocks)
    return "Count=0"


def _xts(root: Path, flip: bool) -> str:
    pt = kat.PLAINTEXT
    for klen, key, ct in ((128, kat.CIPHER_KEY, kat.XTS128),
                          (256, kat.CIPHER_KEY + kat.SECOND_KEY, kat.XTS256)):
        ct_hex = ct.hex()
        if flip and klen == 128:
            ct_hex = _flip_hex(ct_hex)
        blocks = [_kv(COUNT=1, DataUnitLen=8 * len(pt), Key=key.hex(), i=kat.IVEC.hex(),
                      PT=pt.hex(), CT=ct_hex)]
        # a bit-granular data unit: the harness leaves such records out
        bits = 8 * len(pt) - 4
        blocks.append(_kv(COUNT=2, DataUnitLen=bits, Key=key.hex(), i=kat.IVEC.hex(),
                          PT=pt.hex(), CT=xts_encrypt(key, kat.IVEC, pt, bit_len=bits,
                                                      device="cpu").hex()))
        _write(root / f"XTSGenAES{klen}.rsp",
               f"# CAVS 11.0\n# XTSGen information\n# AES{klen}\n\n[ENCRYPT]\n", blocks)
    return "COUNT=1"


def _cmac(root: Path, flip: bool) -> str:
    pt = kat.PLAINTEXT
    for klen in (128, 192, 256):
        key = kat.CIPHER_KEY[: klen // 8]
        if klen == 128:
            # the published MAC, whole and cut to 8 bytes
            recs = [(pt, 16, kat.CMAC128), (pt, 8, kat.CMAC128[:8])]
        else:
            # an empty message is written as one zero byte with Mlen = 0
            macs = cmac_batch([key, key], [pt, b""], device="cpu")
            recs = [(pt, 16, macs[0]), (b"", 16, macs[1])]
        blocks = []
        for count, (msg, tlen, mac) in enumerate(recs):
            mac_hex = mac.hex()
            if flip and klen == 128 and count == 0:
                mac_hex = _flip_hex(mac_hex)
            blocks.append(_kv(Count=count, Klen=klen // 8, Mlen=len(msg), Tlen=tlen,
                              Key=key.hex(), Msg=(msg or b"\x00").hex(), Mac=mac_hex))
        _write(root / f"CMACGenAES{klen}.rsp",
               f"# CAVS 11.0\n# \"CMAC Gen\" information for \"AES{klen}\"\n\n[Mlen = *]\n",
               blocks)
    return "Count=0"


def _gcm_siv(root: Path, flip: bool) -> str:
    blocks = []
    for count, (_, key, nonce, aad, pt, ct) in enumerate(kat.GCM_SIV_VECTORS):
        pt_hex = pt.hex()
        if flip and count == 0:
            pt_hex = _flip_hex(pt_hex)
        blocks.append(_kv(Count=count, key=key.hex(), iv=nonce.hex(), aad=aad.hex(),
                          pt=pt_hex, ct=ct.hex()))
    _write(root / "SIV_GCM_ACVP.tv", "# AES-GCM-SIV (RFC 8452)\n", blocks)
    return "Count=0"


def _poly1305(root: Path, flip: bool) -> str:
    mac_hex = kat.POLY1305_128.hex()
    if flip:
        mac_hex = _flip_hex(mac_hex)
    pt = kat.PLAINTEXT
    _write(root / "Poly1305AES128.tv", "# Poly1305-AES\n",
           [_kv(Count=0, Keys=kat.CIPHER_KEY.hex(), Nonce=kat.IVEC.hex(), Mlen=len(pt),
                Msg=pt.hex(), PolyMac=mac_hex)])
    return "Count=0"


def _eax(root: Path, flip: bool) -> str:
    key = kat.CIPHER_KEY[:16]
    msg_hex = kat.PLAINTEXT.hex()
    if flip:
        msg_hex = _flip_hex(msg_hex)
    _write(root / "EAX_AES128.tv", "# EAX (AES-128)\n",
           [_kv(": ", MSG=msg_hex, KEY=key.hex(), NONCE=kat.IVEC.hex(), HEADER=kat.AAD.hex(),
                CIPHER=kat.EAX128.hex())])
    return f"KEY={key.hex()}"


def _ocb(root: Path, flip: bool) -> str:
    blocks = []
    recs = [(key, nonce, aad, pt, blob[:-16], blob[-16:])
            for _, key, nonce, aad, pt, blob in kat.OCB_VECTORS]
    for i, (key, nonce, aad, pt, ct, tag) in enumerate(recs):
        ct_hex = ct.hex()
        if flip and i == 0:
            ct_hex = _flip_hex(ct_hex)
        blocks.append(_kv(Cipher="aes-128-ocb", Key=key.hex(), IV=nonce.hex(), AAD=aad.hex(),
                          Tag=tag.hex(), Plaintext=pt.hex(), Ciphertext=ct_hex))
    # a forged tag: the harness requires AuthenticationError
    key, nonce, aad, pt, ct, tag = recs[-1]
    blocks.append(_kv(Cipher="aes-128-ocb", Key=key.hex(), IV=nonce.hex(), AAD=aad.hex(),
                      Tag=_flip_hex(tag.hex()), Plaintext=pt.hex(), Ciphertext=ct.hex(),
                      Operation="DECRYPT", Result="CIPHERFINAL_ERROR"))
    _write(root / "OCB_AES128.tv", "# AES-128-OCB (RFC 7253)\n", blocks)
    return "case 0"


def _fpe(root: Path, flip: bool) -> str:
    key = kat.CIPHER_KEY[:16]
    ff1_ct = kat.FPE_FF1_CIPHER
    if flip:
        ff1_ct = _flip_digits(ff1_ct)
    # "FF3" with a 7-byte tweak is FF3-1 (the harness picks by tweak length)
    recs = [("FF1", kat.AAD, kat.FPE_PLAIN, ff1_ct),
            ("FF3", kat.AAD[:7], kat.FPE_PLAIN[:55], kat.FPE_FF3_CIPHER)]
    _write(root / "FPE_FF1&FF3&FF3-1.tv", "# FPE FF1, FF3 and FF3-1\n",
           [_kv(Count=count, Method=method, Alphabet="0123456789", Key=key.hex(),
                Tweak=tweak.hex(), PT=pt, CT=ct)
            for count, (method, tweak, pt, ct) in enumerate(recs)])
    return "Count=0"


def report_status(out: str) -> dict[str, str]:
    """{report name: "ok" or "FAIL"} from the harness's printed suite lines."""
    return {line.split(":")[0].strip(): line.rsplit("[", 1)[1].rstrip("]")
            for line in out.splitlines() if line.endswith("]")}


def write_corpus(root, flip: bool = False) -> dict[str, str]:
    """Write the nine suites' files under root (a directory that exists);
    return {report name of the flipped record: its failure-log line}."""
    root = Path(root)
    writers = {"GCM": _gcm, "CCM": _ccm, "XTS": _xts, "CMAC": _cmac, "GCMSIV": _gcm_siv,
               "POLY1305": _poly1305, "EAX": _eax, "OCB": _ocb, "FPE": _fpe}
    return {FLIPPED[suite]: write(root, flip) for suite, write in writers.items()}
