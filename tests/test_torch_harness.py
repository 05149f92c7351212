"""The port's conformance harness and tooling against the JAX package's:
micro_aes_tpu_torch.testing.run against micro_aes_tpu.testing.run on the KAT
corpus of tests/_torch_corpus.py, clean and with one answer flipped per
suite; examples/demo_torch.py against examples/demo.py's labels;
gpu_selftest.py against tpu_selftest.py's checks; the port's testing/kat
against JAX's names.  Everything runs on the CPU: the JAX harness with its
GCM runner held to JAX's per-message gcm_encrypt (its jitted batch engine
would compile once per key size), the port with device cpu."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from micro_aes_tpu.modes import bulk as jbulk
from micro_aes_tpu.modes.gcm import gcm_encrypt as jgcm_encrypt
from micro_aes_tpu.testing import kat as jkat
from micro_aes_tpu.testing import rsp as jrsp
from micro_aes_tpu.testing import run as jrun
from micro_aes_tpu_torch.testing import kat, rsp, run

sys.path.insert(0, os.path.dirname(__file__))
from _torch_corpus import FLIPPED, REPORTS, report_status, write_corpus  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DEMO = ROOT / "examples" / "demo_torch.py"
SELFTEST = ROOT / "gpu_selftest.py"


def _check_labels(path: Path) -> list[str]:
    """The first argument of every check(...) call in a script, in order."""
    tree = ast.parse(path.read_text())
    calls = [n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "check"]
    return [c.args[0].value for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset))]


# -- testing/kat: JAX's public names ------------------------------------------

JAX_KAT_NAMES = sorted(n for n, v in vars(jkat).items()
                       if not n.startswith("_") and isinstance(v, (bytes, str, tuple)))


@pytest.mark.parametrize("name", JAX_KAT_NAMES)
def test_kat_names(name):
    assert getattr(kat, name) == getattr(jkat, name)


# -- testing/run against JAX's --------------------------------------------------

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{flip: (corpus directory, {report: failure-log line of the flipped record})}"""
    out = {}
    for flip in (False, True):
        root = tmp_path_factory.mktemp("flipped" if flip else "clean")
        out[flip] = (root, write_corpus(root, flip=flip))
    return out


def _jax_gcm_per_message(keys, nonces, aads, pts):
    return [jgcm_encrypt(k, n, a, p) for k, n, a, p in zip(keys, nonces, aads, pts)]


def _harness(main, argv, logdir: Path, monkeypatch, capsys):
    """(exit code, stdout, {failure log: its text}) of one harness run in logdir."""
    logdir.mkdir()
    monkeypatch.chdir(logdir)
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out, {p.name: p.read_text()
                                         for p in sorted(logdir.glob("*failure.log"))}


@pytest.mark.parametrize("flip", [False, True], ids=["clean", "flipped"])
def test_harness_matches_jax(flip, corpora, tmp_path, monkeypatch, capsys):
    """The same suite lines, totals, failure logs and exit code as JAX's
    harness; clean, every suite ok and exit 0; flipped, FAIL on the flipped
    record's report of every suite (and on no other), a log naming it, exit 1."""
    root, flipped = corpora[flip]
    monkeypatch.setattr(rsp, "REFERENCE_VECTORS", root)
    monkeypatch.setattr(jrsp, "REFERENCE_VECTORS", root)
    monkeypatch.setattr(jbulk, "gcm_encrypt_batch", _jax_gcm_per_message)
    port = _harness(run.main, ["--device", "cpu"], tmp_path / "port", monkeypatch, capsys)
    ref = _harness(jrun.main, ["--backend", "cpu"], tmp_path / "jax", monkeypatch, capsys)
    assert port == ref
    rc, out, logs = port
    status = report_status(out)
    assert sorted(status) == sorted(REPORTS)
    assert sorted(flipped) == sorted(FLIPPED.values())
    bad = set(flipped) if flip else set()
    assert {name for name, s in status.items() if s == "FAIL"} == bad
    assert all(status[name] == "ok" for name in set(REPORTS) - bad)
    assert rc == (1 if flip else 0)
    assert sorted(logs) == sorted(f"{name}failure.log" for name in bad)
    for name in bad:
        assert flipped[name] in logs[f"{name}failure.log"].splitlines()


def test_harness_needs_cuda(monkeypatch, capsys):
    """No GPU and no --device cpu: exit 2, no suite run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main([]) == 2
    assert "cases" not in capsys.readouterr().out


# -- examples/demo_torch.py ---------------------------------------------------

def test_demo_cpu(tmp_path):
    r = subprocess.run([sys.executable, str(DEMO), "--cpu"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    labels = _check_labels(ROOT / "examples" / "demo.py")
    assert len(labels) == 19 and _check_labels(DEMO) == labels
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines() == [f"AES-128 {x}: PASSED!" for x in labels] + ["", "19/19 passed"]


# -- gpu_selftest.py ------------------------------------------------------------

def test_selftest_cpu(tmp_path):
    """The 27 checks of tpu_selftest.py, by name and in order (the first
    names the port's demo), all passing on the CPU."""
    out = tmp_path / "selftest.json"
    r = subprocess.run([sys.executable, str(SELFTEST), "--device", "cpu", "--out", str(out)],
                       capture_output=True, text=True, timeout=900, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    names = _check_labels(ROOT / "tpu_selftest.py")
    assert len(names) == 27
    names[0] = "KAT sweep (examples/demo_torch.py)"
    rec = json.loads(out.read_text())
    assert [c["name"] for c in rec["checks"]] == names
    assert all(c["ok"] for c in rec["checks"]) and (rec["passed"], rec["failed"]) == (27, 0)
    printed = [json.loads(line) for line in r.stdout.splitlines() if line.startswith('{"check"')]
    assert printed == [{"check": n, "ok": True} for n in names]


def test_selftest_needs_cuda(tmp_path):
    """Without a GPU and without --device cpu: exit 2, no check run."""
    out = tmp_path / "selftest.json"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, str(SELFTEST), "--out", str(out)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path, env=env)
    assert r.returncode == 2, r.stdout + r.stderr
    assert '"check"' not in r.stdout
    assert json.loads(out.read_text())["selftest"] == "skipped"
