"""What the metric readers in ``metrics/`` share.

A reader is ``metrics/<metric name>.py`` with ``read(ctx)``, which returns
the metric's value or None when its run holds nothing to read.  ``ctx``:
``window_s`` and ``jobs`` (the measured window and the jobs it ran),
``setup_s``, ``peaks`` (each job's peak device bytes), ``spans`` (each job's
harness spans, name -> seconds), ``stats`` (each job's ``stats=`` dict from
the program), ``trace`` (a :class:`trace.Summary` in a traced run, else
None), ``shape`` (:func:`roofline.shape_of`) and ``device_kind``.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_file(folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(name: str):
    """The reader of the metric ``name``."""
    return load_file("metrics", name)


def mean_span(ctx, *names):
    """Mean over the window's jobs of the summed seconds of the spans."""
    vals = [sum(s[n] for n in names) for s in ctx.spans if all(n in s for n in names)]
    return sum(vals) / len(vals) if vals else None


def mean_stat(ctx, *names):
    """Mean over the jobs of the summed stages of the program's ``stats``
    (each a list of seconds, one entry a call)."""
    vals = [sum(sum(s[n + "_s"]) for n in names) for s in ctx.stats
            if all(n + "_s" in s for n in names)]
    return sum(vals) / len(vals) if vals else None


def idle_pct(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
