"""The comparison that decides `correct` can fail: the control, and the
faults a cell can have, each put under a run at a size a test holds.

These runs skip the harness's look for a card: the program runs its plain
versions on the CPU, and the control or the fault sits in its place."""
import importlib
import types

import pytest

from perfbench import harness

from .test_perfbench_harness import CELLS, SMALL


def _run(cell, api, seed=2**31 + 9):
    res = harness.run(cell, seed, 0.3, False, device="cpu", api=api,
                      config_overrides=SMALL[cell][0], mix_overrides=SMALL[cell][1])
    return harness.passed(harness.check(res, "cpu")), res


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    _, config, _ = harness.cell_files(cell)
    ok, res = _run(cell, importlib.import_module(f"perfbench.controls.{config['control']}"))
    assert not ok and res["window"].failed == 0


def _faulty(fault: str):
    """The program's API with a fault under the timed path."""
    import micro_aes_tpu_torch as port

    def unchanged(entry):
        def fn(*args, device):
            data = args[3] if entry.startswith("gcm") else args[2]
            return list(data) if entry.startswith("gcm") else bytes(data)
        return fn

    def half(entry):
        def fn(*args, device):
            real = getattr(port, entry)
            if entry.startswith("gcm"):
                n = len(args[0])
                out = real(*(a[: n // 2] for a in args), device=device)
                return out + out[: n - n // 2]
            keys, ids, data, ss = args
            s = len(ids) // 2
            out = real(keys, ids[:s], data[: s * ss], ss, device=device)
            return out + out[: (len(ids) - s) * ss]
        return fn

    def altered(entry):
        def fn(*args, device):
            out = getattr(port, entry)(*args, device=device)
            if isinstance(out, list):
                k = next(i for i in range(len(out) - 1, -1, -1) if out[i])
                out = list(out)
                out[k] = bytes([out[k][0] ^ 1]) + out[k][1:]
                return out
            return bytes([out[0] ^ 1]) + out[1:]
        return fn

    make = {"unchanged": unchanged, "half": half, "altered": altered}[fault]
    return types.SimpleNamespace(**{e: make(e) for e in (
        "gcm_seal_batch", "gcm_open_batch", "xts_seal_sectors", "xts_open_sectors")})


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_comes_out_not_correct(cell, fault):
    ok, _ = _run(cell, _faulty(fault))
    assert not ok
