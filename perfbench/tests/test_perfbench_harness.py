"""The benchmark's files, generators, arithmetic and harness, on the CPU."""
import importlib
import json
import re
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench.metrics import _h100

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# each cell at a size a test run holds: (configuration, traffic mix) overrides
SMALL = {
    "tls_full_records": ({"connections": 8}, {"record_bytes": 64}),
    "tls_small_records": ({"connections": 130}, {"record_bytes": [1, 100]}),
    "disk_xts_4k": ({}, {"requests_per_call": 2, "request_bytes": 8192}),
}


def traffic_of(cell, seed, small=True):
    _, config, mix = harness.cell_files(cell)
    if small:
        config.update(SMALL[cell][0])
        mix.update(SMALL[cell][1])
    gen = importlib.import_module(f"perfbench.traffic.{mix['generator']}")
    return gen.Traffic(config, mix, seed)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_name_what_exists(cell):
    wl, config, mix = harness.cell_files(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert {k: entry[k] for k in ("config", "traffic", "chips", "why")} == wl
    cfg = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert (ROOT / cfg["file"]).exists() and cfg["file"].endswith(f"/{wl['config']}.json")
    assert config["reduced"] == cfg["reduced"] and config["source"] == cfg["source"]
    assert (harness.HERE / "traffic" / f"{mix['generator']}.py").exists()
    control = importlib.import_module(f"perfbench.controls.{config['control']}")
    assert all(callable(getattr(control, e)) for e in config["entries"])


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(importlib.import_module(f"perfbench.metrics.{m['name']}").read)
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_generators_repeat_for_a_seed_and_differ_across_seeds(cell):
    big = 2**31 + 77
    a, b, c = traffic_of(cell, big), traffic_of(cell, big), traffic_of(cell, big + 1)
    for i in range(3):
        ca, cb, cc = a.call(i, None), b.call(i, None), c.call(i, None)
        assert ca.args == cb.args and ca.entry == cb.entry
        assert ca.args != cc.args
    assert a.cold_call(0).args == b.cold_call(0).args != a.call(0, None).args


def _fast_path(keys, nonces, pts):
    """modes/seal_batch._fast_path_ok's rule, written out: one key size,
    96-bit nonces, whole-block records."""
    return (len({len(k) for k in keys}) == 1 and all(len(n) == 12 for n in nonces)
            and all(len(p) % 16 == 0 for p in pts))


def test_small_records_never_take_the_whole_block_route_full_records_always_do():
    small, full = traffic_of("tls_small_records", 3, False), traffic_of("tls_full_records", 3, False)
    for i in range(4):
        call = small.call(2 * i, None)
        assert call.entry == "gcm_seal_batch" and not _fast_path(*call.args[:2], call.args[3])
        call = full.call(i, None)
        assert call.entry == "gcm_seal_batch" and _fast_path(*call.args[:2], call.args[3])
    lens = sorted(len(p) for p in small.pool[0])
    assert lens[0] >= 1 and lens[-1] <= 1400 and len(lens) == 1024
    assert all(sorted(len(p) for p in batch) == lens for batch in small.pool)


def test_work_counts_match_a_hand_count():
    tls = traffic_of("tls_full_records", 1)  # 8 connections x 64 B
    w = tls.call(0, None).work
    assert w == {"aes": [(10, False, 8 * 4 + 8)], "ghash_blocks": 8 * 4 + 8 * 2,
                 "bytes": 2 * 8 * 64 + 8 * (12 + 13 + 16 + 16)}
    disk = traffic_of("disk_xts_4k", 1)  # 2 requests x 8 KiB, 4 sectors
    call = disk.call(0, None)
    read = call.entry == "xts_open_sectors"
    assert call.work == {"aes": [(14, read, 1024), (14, False, 4)], "bytes": 2 * 16384 + 32 + 64}
    # the gate counts by hand: rounds x (16 S-boxes + AddRoundKey) + mixes + the first key
    assert _h100.aes_gates(10) == 10 * (16 * 115 + 128) + 9 * 528 + 128 == 24560
    assert _h100.aes_gates(14) == 34544
    assert _h100.aes_gates(14, True) == 14 * (16 * (29 + 62 + 35) + 128) + 13 * 880 + 128 == 41584
    ms = _h100.least_ms({"aes": [(10, False, 32)], "ghash_blocks": 32, "bytes": 512})
    assert ms == pytest.approx(1e3 * max(24560 / 2 / _h100.INT32_PER_S,
                                         32 * 2 * 128 * 128 / _h100.TENSOR_OPS_PER_S,
                                         512 / _h100.HBM_BYTES_PER_S))


def test_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["jax.numpy", "micro_aes_tpu.core", "micro_aes_tpu_torch.ops", "jaxlib", "flax.linen"]
    ) == ["flax", "jax", "jaxlib", "micro_aes_tpu"]
    assert harness.forbidden_modules(["micro_aes_tpu_torch", "micro_aes_tpu_torch.modes",
                                      "jaxtyping", "flaxen", "numpy"]) == []


def test_trace_reduction_on_a_synthetic_trace(tmp_path):
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", "perfbench.call", 0, 100), x("user_annotation", "perfbench.call", 200, 100),
        x("cpu_op", "aten::copy_", 5, 10),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 10),
        x("kernel", "void (anonymous namespace)::multikey_kernel<true>(Args)", 20, 30),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 40, 20),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 80, 10),
        x("kernel", "void (anonymous namespace)::chain_fold_kernel(Args)", 210, 40),
        x("gpu_memset", "Memset (Device)", 260, 5),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    works = [{"aes": [], "bytes": 0}, {"aes": [], "bytes": 0}]
    t = trace.summarize(path, works, ["multikey_kernel", "chain_fold_kernel"], lambda w: 0.01)
    a, b = t.calls
    assert (a.wall_us, a.device_us, a.copy_us, a.kernel_us, a.glue_us, a.glue_n) == (100, 60, 20, 30, 20, 1)
    assert (b.device_us, b.kernel_us, b.glue_us, b.glue_n) == (45, 40, 5, 1)
    assert t.window_us == 200 and t.busy_us == 105  # inside the calls only
    run = {"trace": t}
    read = {m: importlib.import_module(f"perfbench.metrics.{m}").read(run)
            for m in ("host_ms_per_call", "copy_ms_per_call", "glue_ms_per_call",
                      "glue_launches_per_call", "kernel_ms_per_call", "compute_roofline",
                      "device_idle_pct", "device_compute_ms_per_call")}
    assert read == pytest.approx({"host_ms_per_call": 0.0475, "copy_ms_per_call": 0.01,
                                  "glue_ms_per_call": 0.0125, "glue_launches_per_call": 1,
                                  "kernel_ms_per_call": 0.035, "compute_roofline": 100 * 0.02 / 0.095,
                                  "device_idle_pct": 47.5, "device_compute_ms_per_call": 0.0475})
    assert dict(t.device_ops)["multikey_kernel<true>"] == pytest.approx(30e-6)
    gaps = dict(t.idle_gaps)  # A: 0..10, 60..80, 90..100; B: 200..210, 250..260, 265..300
    assert gaps["after aten::copy_"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(95e-6)


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def test_the_frozen_kernel_list_covers_every_kernel_of_the_program():
    """A kernel the program gains (a CUDA `__global__` function, or a
    Triton kernel) must be named under perfbench/kernels/ before the trace
    counts it as the kernels layer's, so the split never moves unseen."""
    pkg = ROOT / "micro_aes_tpu_torch"
    in_sources = set()
    for path in sorted((pkg / "csrc").glob("*.cu*")):
        in_sources.update(_GLOBAL.findall(path.read_text()))
    listed = set(trace.port_kernel_names())
    assert in_sources and in_sources <= listed, sorted(in_sources - listed)
    jitted = [str(p.relative_to(ROOT)) for p in sorted(pkg.rglob("*.py"))
              if "triton.jit" in p.read_text()]
    assert not jitted, f"Triton kernels not in perfbench/kernels/: {jitted}"


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_on_the_cpu_is_correct(cell):
    res = harness.run(cell, 2**31 + 5, 0.3, False, device="cpu",
                      config_overrides=SMALL[cell][0], mix_overrides=SMALL[cell][1])
    checks = harness.check(res, "cpu")
    assert harness.passed(checks), checks
    assert checks["checked_answers"]["value"] > 0 and res["window"].latencies_s
    assert len(res["window"].cold_s) == res["mix"]["cold_calls"] and not res["forbidden"]


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_profiles_its_window_or_the_calls_after_it(trace):
    """--trace 0 profiles every call of the window; --trace 1 leaves the
    window unprofiled and profiles the mix's trace_calls after it."""
    cell = "disk_xts_4k"
    res = harness.run(cell, 2**31 + 6, 0.3, trace, device="cpu", profile_window=not trace,
                      config_overrides=SMALL[cell][0], mix_overrides=SMALL[cell][1])
    assert harness.passed(harness.check(res, "cpu"))
    calls = len(res["window"].latencies_s)
    traced = res["mix"]["trace_calls"] if trace else calls
    assert calls and len(res["trace"].calls) == traced
    assert (res["traced"] is not None) == trace
    if trace:
        assert len(res["traced"].latencies_s) == traced
    # no device here: the card's readers find nothing and report nothing
    device_compute = importlib.import_module("perfbench.metrics.device_compute_ms_per_call")
    assert device_compute.read(res) is None


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "disk_xts_4k", "--seed", "12", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                    if "disk_xts_4k" in m.get("workloads", CELLS)}
