"""The device's side of a traced window, from ``torch.profiler``.

The harness wraps the window in one profile (CPU and CUDA activities) and
marks the window and each span with ``record_function``.  The trace is
written as Chrome JSON under the run's temporary directory, read once and
deleted.  From it: the device intervals (kernels, copies, fills), their
union within the window (the device's busy time), each kernel's launches
and device seconds, and the idle gaps by the span the host was in.
"""

from __future__ import annotations

import dataclasses
import json
import os

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernels: dict  # symbol substring -> (launches, device seconds)
    device_ops: list  # [[name, seconds]] of the most device time, at most 10
    idle_gaps: list  # [[host span, idle seconds]], at most 10


def profile():
    from torch.profiler import ProfilerActivity, profile as _profile

    return _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _short(name: str) -> str:
    """A device op's name without its return type, namespace marks and
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:120]


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, kernels, spans) -> Summary:
    """``events``: Chrome trace events; ``kernels``: symbol substrings to
    count; ``spans``: the host span names to blame idle gaps on."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace has no window mark")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1 and b > a])
    busy_us = sum(b - a for a, b in busy)
    per_kernel = {}
    by_name = {}
    for a, b, name in dev:
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + (b - a)
        for k in kernels:
            if k in name:
                c, s = per_kernel.get(k, (0, 0.0))
                per_kernel[k] = (c + 1, s + (b - a) / 1e6)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") in spans), key=lambda s: s[0])
    gaps, at = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > at:
            mid = (a + at) / 2
            inside = [s for s in host if s[0] <= mid <= s[1]]
            name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "between spans"
            gaps[name] = gaps.get(name, 0.0) + (a - at) / 1e6
        at = max(at, b)
    return Summary(busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6, kernels=per_kernel,
                   device_ops=[[n, s / 1e6] for n, s in ops],
                   idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])


def read(prof, tmp: str, kernels, spans) -> Summary:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, kernels, spans)
