"""Stage seconds and profiler marks: the port's one tracer.

A :class:`Stages` wraps each named stage of a call.  With a ``stats`` dict
the stage synchronizes the device at both ends and appends its host seconds
to ``stats[name + "_s"]``, one entry a call.  Whenever ``torch.profiler`` is
recording, the stage also opens ``record_function("tdb." + name)`` around
its body, with or without ``stats``, so that the stage lies on the trace's
clock beside the device's work; the ``tdb.`` prefix keeps these marks apart
from a caller's own.  With neither, a stage runs its body and nothing else.

Stages nest: a parent's self time is its seconds less its children's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

PREFIX = "tdb."


def profiling() -> bool:
    """Whether a profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


class Stages:
    """Host seconds by stage into ``stats`` (a dict; None times nothing),
    and a profiler mark a stage while a profiler records.  A timed stage
    starts and ends with a device synchronize."""

    def __init__(self, stats: Optional[dict], device):
        self.stats = stats
        device = torch.device(device)
        self.sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
            else (lambda: None)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.stats is None:
            if not profiling():
                yield
                return
            with torch.profiler.record_function(PREFIX + name):
                yield
            return
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name) if profiling() \
                else contextlib.nullcontext():
            yield
            self.sync()
        self.stats.setdefault(name + "_s", []).append(time.perf_counter() - t0)
