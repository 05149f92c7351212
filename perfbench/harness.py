"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name: `workloads/<cell>.json` names a
configuration (`configs/<config>.json`) and a traffic mix
(`traffic/<mix>.json`), the mix names its generator (`traffic/<gen>.py`),
and each metric is read by `metrics/<metric>.py`.  The program is reached
only through its public functions, looked up by name on the API namespace
(the package `micro_aes_tpu_torch`, or a control put in its place).

The window is a closed loop of one caller: one API call after another,
each timed from the call to the bytes it returns.  A sample of the calls
(a reservoir drawn from the seed, and the last call) is copied aside and
compared with the plain reference once the window has closed.

A run profiles either its whole window (`profile_window`: the card's time
per call over every call of the window, an end-to-end reading) or, after
an unprofiled window (`trace`: the host clock's readings), the mix's
`trace_calls` further calls (the per-layer breakdown).
"""
from __future__ import annotations

import contextlib
import importlib
import json
import random
import resource
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .traffic import Call

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "micro_aes_tpu")


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell_files(cell: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic mix) of a cell, by name."""
    wl = load("workloads", cell)
    return wl, load("configs", wl["config"]), load("traffic", wl["traffic"])


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (so `micro_aes_tpu_torch` passes)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Window:
    latencies_s: list = field(default_factory=list)
    payload_bytes: int = 0
    wall_s: float = 0.0
    failed: int = 0
    setup_s: float = 0.0
    library_s: float = 0.0     # of setup_s: the kernel library's load, with its build
    build_s: float = 0.0       # of library_s: nvcc, in a checkout's first run only
    cold_s: list = field(default_factory=list)
    cpu_s: tuple = (0.0, 0.0)  # the process's (user, system) CPU seconds in the window


class Slot:
    """Host memory of the harness's own into which a sampled call's inputs
    and output are copied, so that the sample holds none of the program's
    objects (keeping them would change how the program's allocations
    behave for the rest of the window)."""

    def __init__(self, nbytes: int):
        self.buf = np.ones(nbytes, np.uint8)  # every page touched now, not in the window
        self.used = 0

    def freeze(self, obj):
        """obj with every bytes object in it copied here, as a reference."""
        if isinstance(obj, (bytes, bytearray)):
            n = len(obj)
            self.buf[self.used:self.used + n] = np.frombuffer(obj, np.uint8)
            self.used += n
            return _Ref(self.used - n, n)
        if isinstance(obj, list) and obj and all(x is None or type(x) is bytes for x in obj):
            ref = self.freeze(b"".join(x for x in obj if x is not None))  # one copy in all
            out, off = [], ref.off
            for x in obj:
                out.append(None if x is None else _Ref(off, len(x)))
                off += 0 if x is None else len(x)
            return out
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.freeze(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self.freeze(v) for k, v in obj.items()}
        return obj

    def thaw(self, obj):
        if isinstance(obj, _Ref):
            return self.buf[obj.off:obj.off + obj.n].tobytes()
        if isinstance(obj, (list, tuple)):
            return type(obj)(self.thaw(x) for x in obj)
        if isinstance(obj, dict):
            return {k: self.thaw(v) for k, v in obj.items()}
        return obj

    def keep(self, i, call, out):
        """Copy (i, call, out) in, growing the slot if it is too small."""
        need = _nbytes((call.args, call.expect, out))
        if need > len(self.buf):
            self.buf = np.empty(need, np.uint8)
        self.used = 0
        self.item = (i, Call(call.entry, self.freeze(call.args), call.payload, call.work,
                             self.freeze(call.expect)), self.freeze(out))

    def get(self):
        i, call, out = self.item
        return i, Call(call.entry, self.thaw(call.args), call.payload, call.work,
                       self.thaw(call.expect)), self.thaw(out)


def _nbytes(obj) -> int:
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(x) for x in obj.values())
    return 0


@dataclass(frozen=True)
class _Ref:
    off: int
    n: int


class Sample:
    """A reservoir of k calls drawn from the seed, and the last call; the
    kept calls are copied into k slots made before the window, each sized
    for `headroom` times the example call given."""

    def __init__(self, k: int, seed: int, example, headroom: float = 2.5):
        self.rng = random.Random(f"perfbench-sample-{seed}")
        size = int(headroom * _nbytes((example[1].args, example[1].expect, example[2])))
        self.slots = [Slot(size) for _ in range(k)]
        self.filled, self.seen, self.last = 0, 0, None

    def offer(self, item) -> None:
        self.seen += 1
        if self.filled < len(self.slots):
            self.slots[self.filled].keep(*item)
            self.filled += 1
        else:
            j = self.rng.randrange(self.seen)
            if j < len(self.slots):
                self.slots[j].keep(*item)
        self.last = item

    def items(self) -> list:
        out = sorted((slot.get() for slot in self.slots[:self.filled]), key=lambda it: it[0])
        if self.last is not None and all(it[0] != self.last[0] for it in out):
            out.append(self.last)
        return out


def _span(name: str, on: bool):
    if on:
        from torch.profiler import record_function

        return record_function(name)
    return contextlib.nullcontext()


def _invoke(api, call, device):
    return getattr(api, call.entry)(*call.args, device=device)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def loop(api, traffic, start: int, last, seconds: float, max_calls: int, device,
         window: Window, sample: Sample, spans: bool = False) -> list:
    """Calls start, start+1, ... (`last` the output of the call before
    start) until `seconds` have passed or max_calls are done.  Returns the
    works of the calls made, the next call's index and the last output."""
    works, i = [], start
    ru = resource.getrusage(resource.RUSAGE_SELF)
    t_open = time.perf_counter()
    while i - start < max_calls and time.perf_counter() - t_open < seconds:
        with _span("perfbench.stage", spans):
            call = traffic.call(i, last)
        with _span("perfbench.call", spans):
            t0 = time.perf_counter()
            try:
                out = _invoke(api, call, device)
            except Exception:  # a failed call is counted, and the window goes on
                if not window.failed:
                    traceback.print_exc()
                window.failed += 1
                out = None
            t1 = time.perf_counter()
        window.latencies_s.append(t1 - t0)
        if out is not None:
            window.payload_bytes += call.payload
        works.append(call.work)
        sample.offer((i, call, out))
        last, i = out, i + 1
    window.wall_s = time.perf_counter() - t_open
    end = resource.getrusage(resource.RUSAGE_SELF)
    window.cpu_s = (end.ru_utime - ru.ru_utime, end.ru_stime - ru.ru_stime)
    return works, i, last


def profiled(calls):
    """Run `calls()` (which returns the works of the calls it made, each in a
    `perfbench.call` span) under torch.profiler, and reduce its trace to
    per-call device times (trace.summarize)."""
    from torch.profiler import ProfilerActivity, profile

    from . import trace as tr

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        works = calls()
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return tr.summarize(path, works)


def run(cell: str, seed: int, seconds: float, trace: bool, *, device="cuda", api=None,
        t_start: float | None = None, max_calls: int | None = None, cold: bool = True,
        profile_window: bool = False, config_overrides: dict | None = None,
        mix_overrides: dict | None = None) -> dict:
    """One run of `cell`.  Returns a dict with the window, the sample's
    check, the trace summary (of the window with `profile_window`, of the
    calls after it with `trace`) and the device readings."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    wl, config, mix = cell_files(cell)
    config.update(config_overrides or {})
    mix.update(mix_overrides or {})
    window = Window()
    program = api is None
    if program:
        import micro_aes_tpu_torch as api
    if program and torch.device(device).type == "cuda":
        from micro_aes_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load()  # built here on a checkout's first run, so that its time shows apart
        window.library_s, window.build_s = time.perf_counter() - t0, _build.build_info.seconds
    gen = importlib.import_module(f"perfbench.traffic.{mix['generator']}")
    traffic = gen.Traffic(config, mix, seed)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # warm-up: every shape and direction of the window, under its key set
    last = None
    for i in range(mix["warm_calls"]):
        last = _invoke(api, traffic.call(i, last), device)
    if cold:
        for j in range(mix["cold_calls"]):
            call = traffic.cold_call(j)
            t0 = time.perf_counter()
            _invoke(api, call, device)
            window.cold_s.append(time.perf_counter() - t0)
    # the cold key sets may have pushed the window's out of the caches
    call = traffic.call(mix["warm_calls"], last)
    last = _invoke(api, call, device)
    _sync(device)
    start = mix["warm_calls"] + 1
    sample = Sample(mix["check_calls"], seed, (start - 1, call, last))
    window.setup_s = time.perf_counter() - t_start
    limit = max_calls or 1 << 62
    out = {"workload": wl, "config": config, "mix": mix, "window": window, "trace": None,
           "traced": None}
    if profile_window:
        out["trace"] = profiled(lambda: loop(api, traffic, start, last, seconds, limit, device,
                                             window, sample, True)[0])
    else:
        _, start, last = loop(api, traffic, start, last, seconds, limit, device, window, sample)
    if trace:
        traced = out["traced"] = Window()
        out["trace"] = profiled(lambda: loop(api, traffic, start, last, float("inf"),
                                             mix["trace_calls"], device, traced, sample, True)[0])
        window.failed += traced.failed
    out["forbidden"] = forbidden_modules()
    if torch.device(device).type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    else:
        out["memory_peak_bytes"] = 0
    out["sample"] = sample
    out["traffic"] = traffic
    return out


def check(res: dict, device) -> dict:
    """The comparison that decides `correct`, run once the window has
    closed and the program's caches are freed: each number with its limit."""
    import torch
    from micro_aes_tpu_torch.utils.keycache import purge_key_caches

    purge_key_caches()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    traffic, items = res["traffic"], res["sample"].items()
    answers = wrong = 0
    for _, call, out in items:
        n, w = traffic.check(call, out, device)
        answers += n
        wrong += w
    return {"failed_calls": {"value": res["window"].failed, "max": 0},
            "wrong_answers": {"value": wrong, "max": 0},
            "checked_calls": {"value": len(items), "min": 1},
            "checked_answers": {"value": answers, "min": 1}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["max"] if "max" in c else c["value"] >= c["min"]
               for c in checks.values())
