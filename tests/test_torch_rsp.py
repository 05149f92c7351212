"""The port's vector-corpus parser (micro_aes_tpu_torch.testing.rsp) against
the JAX package's (micro_aes_tpu.testing.rsp): the same records from a
hand-written file that covers every rule, from seeded random streams of
lines, and from each loader on the KAT corpus of tests/_torch_corpus.py.
No JAX computation runs here."""
import os
import sys

import numpy as np
import pytest

from micro_aes_tpu.testing import rsp as jrsp
from micro_aes_tpu_torch.testing import rsp

sys.path.insert(0, os.path.dirname(__file__))
from _torch_corpus import write_corpus  # noqa: E402

RULES = """\
# a comment line, then context before any record
Alen = 32
Tlen = 16
a line without the separator

[Nlen = 7]
[ENCRYPT]
Key = 00ff
count = 0
Adata = 01
Payload =
# a comment inside a record
CT = a=b=c
COUNT = 1
Payload = 02
[Nlen = 13]
Key = 11ee
Count = 2
CT = 03
  Count   =   3
[]
Count = 4
"""


def test_rules(tmp_path):
    """Bracket context ([X = Y] keys, [X] as SECTION), # lines and lines
    without the separator skipped, the trigger in any case, context seen
    before a record inherited, a bracket line closing a record, values split
    at the first separator."""
    path = tmp_path / "rules.rsp"
    path.write_text(RULES)
    recs = list(rsp.parse_records(path, "Count"))
    assert recs == list(jrsp.parse_records(path, "Count"))
    assert len(recs) == 5
    assert recs[0] == {"Alen": "32", "Tlen": "16", "Nlen": "7", "SECTION": "ENCRYPT",
                       "Key": "00ff", "count": "0", "Adata": "01", "Payload": "",
                       "CT": "a=b=c"}
    assert recs[1]["COUNT"] == "1" and recs[1]["Key"] == "00ff" and "CT" not in recs[1]
    assert recs[2]["Nlen"] == "13" and recs[2]["Key"] == "11ee" and recs[2]["CT"] == "03"
    assert recs[3] == {**{k: recs[2][k] for k in ("Alen", "Tlen", "Nlen", "SECTION", "Key")},
                       "Count": "3"}
    assert rsp.hexval(recs[0], "Adata") == b"\x01" and rsp.hexval(recs[0], "Payload") == b""
    assert rsp.hexval(recs[0], "missing") == b""


def test_colon_separator(tmp_path):
    """EAX's `:` files: the trigger starts a record, `=` is no separator."""
    text = "MSG: \nKEY: 00\nX = 1\nMSG: 0102\nKEY: 03\n[note: n]\nMSG:04\n"
    path = tmp_path / "eax.tv"
    path.write_text(text)
    recs = list(rsp.parse_records(path, "MSG", sep=":"))
    assert recs == list(jrsp.parse_records(path, "MSG", sep=":"))
    assert recs == [{"MSG": "", "KEY": "00"}, {"MSG": "0102", "KEY": "03"},
                    {"note": "n", "MSG": "04"}]


_KEYS = ("Count", "COUNT", "count", "Key", "IV", "PT", "CT", "Tag", "MSG", "Cipher", "x")


def _random_stream(seed: int) -> str:
    """Seeded random lines: key-values (either separator, odd spacing, empty
    values), brackets with and without a separator, comments, blank lines
    and junk."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(120):
        kind = rng.integers(0, 8)
        key = _KEYS[rng.integers(0, len(_KEYS))]
        val = rng.integers(0, 256, rng.integers(0, 5), dtype=np.uint8).tobytes().hex()
        sep = "=:"[rng.integers(0, 2)]
        pad = " " * int(rng.integers(0, 3))
        if kind < 4:
            lines.append(f"{pad}{key}{pad}{sep}{pad}{val}")
        elif kind == 4:
            lines.append(f"[{key} {sep} {val}]" if rng.integers(0, 2) else f"[{key}]")
        elif kind == 5:
            lines.append(f"# {key} {sep} {val}")
        elif kind == 6:
            lines.append("")
        else:
            lines.append(f"{key} {val}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(8))
def test_random_streams(seed, tmp_path):
    path = tmp_path / "random.rsp"
    path.write_text(_random_stream(seed))
    for trigger, sep in (("Count", "="), ("MSG", ":"), ("Cipher", "=")):
        assert list(rsp.parse_records(path, trigger, sep)) == \
            list(jrsp.parse_records(path, trigger, sep)), (trigger, sep)


LOADERS = [("load_gcm", k) for k in (128, 192, 256)] + \
          [("load_ccm", k) for k in (128, 192, 256)] + \
          [("load_xts", k) for k in (128, 256)] + \
          [("load_cmac", k) for k in (128, 192, 256)] + \
          [(name, None) for name in ("load_gcm_siv", "load_poly1305", "load_eax", "load_ocb",
                                     "load_fpe")]


@pytest.fixture(scope="module")
def kat_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("kat_corpus")
    write_corpus(root)
    return root


@pytest.mark.parametrize("loader,keylen", LOADERS)
def test_loaders(loader, keylen, kat_corpus, monkeypatch):
    """Each loader reads REFERENCE_VECTORS when it is called, and gives
    JAX's records on the KAT corpus."""
    monkeypatch.setattr(rsp, "REFERENCE_VECTORS", kat_corpus)
    monkeypatch.setattr(jrsp, "REFERENCE_VECTORS", kat_corpus)
    args = () if keylen is None else (keylen,)
    recs = getattr(rsp, loader)(*args)
    assert recs and recs == getattr(jrsp, loader)(*args)


def test_reference_vectors_default():
    """Both packages read the corpus' place from the same variable."""
    assert rsp.REFERENCE_VECTORS == jrsp.REFERENCE_VECTORS
