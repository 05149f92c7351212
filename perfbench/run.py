#!/usr/bin/env python3
"""The benchmark of micro_aes_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (BENCHMARK.json `workloads`, `perfbench/workloads/<cell>.json`) is a
deployment (`configs/`) under a traffic mix (`traffic/`).  The run makes
every input from the seed, warms up the cell's shapes, times the mix's
calls under fresh key sets, then measures its window of `--seconds`
seconds.  With --trace 0 the whole window runs under torch.profiler, and
the run reports the cell's end-to-end metrics (the card's time per call,
the set-up); with --trace 1 the window runs unprofiled (the host clock's
rate and tail), then the mix's `trace_calls` calls run under the profiler,
and the run reports the cell's per-layer metrics.  Then it compares a
sample of the window's outputs, drawn
from the seed, with the plain reference (perfbench/reference), and prints
one JSON line last on standard output; the numbers compared, each with its
limit, are the last lines on standard error and the last key of that line.

It exits non-zero without a result when no CUDA device (or fewer than the
cell's chips) is present, and when JAX or the JAX package `micro_aes_tpu`
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import ctypes  # noqa: E402


def hold_allocator() -> None:
    """Hold glibc's malloc to one policy for the whole run, before anything
    allocates: blocks up to 32 MiB come from the heap, and freed memory stays
    with the process.  By default glibc raises and lowers its mmap threshold
    as blocks come and go and trims the heap's top, so the program's 16 MiB
    buffers of one call went back to the kernel and were faulted in again by
    the next: 1.0-2.6 s of system time in a 15 s window on the H100 host,
    varying run to run, with the card idle."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc: its own policy stands
        return
    m_trim_threshold, m_top_pad, m_mmap_threshold = -1, -2, -3
    libc.mallopt(m_mmap_threshold, 32 << 20)  # glibc's largest; fixed, no longer adaptive
    libc.mallopt(m_trim_threshold, 1 << 30)
    libc.mallopt(m_top_pad, 64 << 20)


hold_allocator()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import from the checkout's root, never from this folder by its bare names
sys.path[0] = str(ROOT)
# a kernel cache stays inside the checkout, at a fixed path (the program's
# own nvcc build goes to micro_aes_tpu_torch/_build/, inside it too)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".perfbench_cache" / "triton"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end (trace 0) or per-layer (trace 1) metrics."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {wl['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    device = "cuda"
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device=device,
                      t_start=T_START, profile_window=not args.trace)
    if res["forbidden"]:
        print(f"perfbench: forbidden modules loaded: {', '.join(res['forbidden'])}",
              file=sys.stderr)
        return 3
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = importlib.import_module(f"perfbench.metrics.{m['name']}").read(res)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    w = res["window"]
    lat = sorted(w.latencies_s)
    print(f"perfbench: {args.workload} seed {args.seed}: {len(lat)} calls, median "
          f"{lat[len(lat) // 2] * 1e3 if lat else float('nan')} ms, setup {w.setup_s} s "
          f"(kernel library {w.library_s} s, of which nvcc {w.build_s} s), "
          f"cold calls {[c * 1e3 for c in w.cold_s]} ms, window CPU user {w.cpu_s[0]} s "
          f"system {w.cpu_s[1]} s", file=sys.stderr)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": wl["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    attempted = len(lat) + (len(res["traced"].latencies_s) if res["traced"] else 0)
    line = {"attempted": attempted, "failed": w.failed, "metrics": metrics, "device": device_info}
    t = res["trace"]
    if args.trace:
        device_info["busy_s"] = t.busy_us * 1e-6
        device_info["window_s"] = t.window_us * 1e-6
        line["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                             "idle_gaps": [list(x) for x in t.idle_gaps]}
    checks = harness.check(res, device)
    if harness.forbidden_modules():
        print(f"perfbench: forbidden modules loaded: {', '.join(harness.forbidden_modules())}",
              file=sys.stderr)
        return 3
    line = {"correct": harness.passed(checks), **line, "checks": checks}
    for name, c in checks.items():
        bound = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name} = {c['value']} (limit {bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
