"""Reduce a torch.profiler Chrome trace of the traced window to per-call
device times.

Each API call of the window is a `perfbench.call` span on the host.  A
device event belongs to the call whose span holds its start (every call
ends by copying its result to the host, so its device work ends inside it
too).  Device events are sorted into three kinds:

* copy: the host-to-device and device-to-host memcpys;
* kernel: the program's own kernels, recognised by the names listed in
  `perfbench/kernels/*.txt` (frozen from its CUDA sources' `__global__`
  functions, so that the split moves only with the benchmark);
* glue: every other kernel, memset and device-to-device copy (PyTorch's).
"""
from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_LISTS = Path(__file__).resolve().parent / "kernels"


def port_kernel_names(lists: Path = KERNEL_LISTS) -> list[str]:
    """The program's kernel names: every line of every `*.txt` in `lists`
    that is not blank or a `#` comment."""
    names = set()
    for path in sorted(lists.glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                names.add(line)
    return sorted(names)


def kind_of(event: dict, port: re.Pattern) -> str:
    name = event["name"]
    if event["cat"] == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name):
        return "copy"
    if event["cat"] == "kernel" and port.search(name):
        return "kernel"
    return "glue"


def short_name(name: str) -> str:
    """A kernel's name without `void`, the anonymous namespace and the
    argument list of its signature, at most 120 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    return name[:120]


def union_us(intervals) -> tuple[float, list]:
    """(covered length, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


@dataclass
class CallStats:
    wall_us: float
    device_us: float = 0.0     # union of the call's device intervals
    copy_us: float = 0.0
    kernel_us: float = 0.0
    glue_us: float = 0.0
    glue_n: int = 0
    least_ms: float = 0.0


@dataclass
class TraceStats:
    calls: list = field(default_factory=list)
    window_us: float = 0.0
    busy_us: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def summarize(path: Path, works: list, kernel_names: list[str] | None = None,
              least_ms=None) -> TraceStats:
    """Per-call device times of the traced window, and its breakdown."""
    if least_ms is None:
        from .metrics._h100 import least_ms
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    names = kernel_names if kernel_names is not None else port_kernel_names()
    port = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == "perfbench.call")
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), kind_of(e, port),
                  short_name(e["name"]) if e["cat"] == "kernel" else e["name"])
                 for e in events if e.get("cat") in DEVICE_CATS)
    stats = TraceStats()
    if not spans:
        return stats
    starts = [s for s, _ in spans]
    per_call = [[] for _ in spans]
    for ev in dev:
        k = bisect.bisect_right(starts, ev[0]) - 1
        if k >= 0 and ev[0] <= spans[k][1]:
            per_call[k].append(ev)
    for (s, e), evs, work in zip(spans, per_call, works):
        c = CallStats(wall_us=e - s, least_ms=least_ms(work))
        c.device_us = union_us((max(a, s), min(b, e)) for a, b, _, _ in evs)[0]
        for a, b, kind, _ in evs:
            if kind == "copy":
                c.copy_us += b - a
            elif kind == "kernel":
                c.kernel_us += b - a
            else:
                c.glue_us += b - a
                c.glue_n += 1
        stats.calls.append(c)
    # the traced window is the time inside the calls: what the harness does
    # between calls (staging, copying its sample aside) is not the system's
    inside = [ev for evs in per_call for ev in evs]
    stats.window_us = sum(c.wall_us for c in stats.calls)
    stats.busy_us = sum(c.device_us for c in stats.calls)
    by_op: dict = {}
    for a, b, _, name in inside:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    stats.device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    stats.idle_gaps = _idle_gaps(events, spans, per_call)
    return stats


def _idle_gaps(events, spans, per_call) -> list:
    """Idle time on the device inside the calls, summed by what the host
    was doing: the host op last started before the gap, and whether the gap
    lay inside it ("in") or after it ("after")."""
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                 if e.get("cat") == "cpu_op")
    op_starts = [o[0] for o in ops]
    by_label: dict = {}
    for (s, e), evs in zip(spans, per_call):
        t = s
        for a, b in union_us((max(x, s), min(y, e)) for x, y, _, _ in evs)[1] + [[e, e]]:
            if a > t:
                k = bisect.bisect_right(op_starts, t) - 1
                label = ("python before any op" if k < 0 or ops[k][0] < s else
                         f"{'in' if ops[k][1] >= a else 'after'} {ops[k][2]}")
                by_label[label] = by_label.get(label, 0.0) + (a - t) * 1e-6
            t = max(t, b)
    return sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
