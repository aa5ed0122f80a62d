"""One run of one cell: set up, a measured window of whole jobs, the check.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is comes from ``BENCHMARK.json`` and files found by name:
its configuration (``configs/``), its traffic mix (``traffic/<name>.json``,
whose ``entry`` names the kind of job, ``jobs/<entry>.py``; see
:mod:`portbench.job`), and a reader a metric (``metrics/<name>.py``).  A run:

1. makes the read set from the seed on the device and sets the job up
   (a FASTQ file for the command line), then warms up with one job;
2. runs jobs back to back until ``--seconds`` have passed; the job in
   flight then finishes and counts.  With ``--trace 1`` the window runs
   under ``torch.profiler``, and is taken again (three times at most) when
   the trace lost every device event or some launch of a kernel that a
   roofline reads;
3. reads the peak, frees the program's state, works the reference out from
   the reads (the kind's ``reference``) and compares the last job's outputs
   with it, and every job's sizes with the reference's.

It prints each number compared beside its limit as the last lines of
standard error, and one JSON line last on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import types

import torch

from portbench import generate, job, readers, roofline, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_debruijn")
TRACE_TRIES = 3


class Cell(types.SimpleNamespace):
    """A workload of ``BENCHMARK.json`` with its files: ``name``, ``chips``,
    ``config``, ``traffic``, ``end_to_end`` and ``per_layer`` (the metric
    entries it reports)."""


def load_cell(root: str, name: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (w,) = [w for w in bench["workloads"] if w["name"] == name]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The harness's own spans, which only the traced run's metrics read:
    there, host seconds synchronized at both ends and marked for the
    profiler.  Untraced, a span does nothing, so that the jobs the
    end-to-end metrics time make no synchronization the program does not."""

    def __init__(self, device, traced: bool):
        self.device, self.traced = device, traced

    def into(self, out: dict):
        @contextlib.contextmanager
        def span(name: str):
            if not self.traced:
                yield
                return
            _sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                yield
                _sync(self.device)
            out[name] = out.get(name, 0.0) + time.perf_counter() - t0
        return span


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _launch_counters(names) -> dict:
    """The program's launch counters of the kernel wrappers ``names``."""
    from tpu_debruijn_torch import kernels as K

    return {name: getattr(K, name).launches for name in names}


def window(work, seconds: float, device, traced: bool, tmp: str, kernels: dict):
    """Jobs back to back for ``seconds``; returns the window's record and,
    traced, its trace summary (``kernels``: roofline name -> symbol)."""
    spans = Spans(device, traced)
    rec = types.SimpleNamespace(spans=[], stats=[], peaks=[], prints=[], walls=[], failed=0,
                                out=None)
    prof = trace.profile() if traced else contextlib.nullcontext()
    before = _launch_counters(kernels)
    with prof:
        with torch.profiler.record_function(trace.WINDOW) if traced else contextlib.nullcontext():
            w0 = time.perf_counter()
            while True:
                rec.out = None
                s, st = {}, {}
                _reset_peak(device)
                t0 = time.perf_counter()
                try:
                    rec.out = work.run(spans.into(s), st)
                    _sync(device)
                    rec.prints.append(tuple(rec.out["sizes"]))
                except Exception:  # a job that fails counts, and the window goes on
                    traceback.print_exc()
                    rec.failed += 1
                    rec.prints.append(None)
                rec.walls.append(time.perf_counter() - t0)
                rec.peaks.append(_peak(device))
                rec.spans.append(s)
                rec.stats.append(st)
                if time.perf_counter() - w0 >= seconds:
                    break
            _sync(device)
            rec.window_s = time.perf_counter() - w0
    rec.jobs = len(rec.prints)
    rec.trace = None
    if traced:
        made = {k: v - before[k] for k, v in _launch_counters(kernels).items()}
        rec.trace = trace.read(prof, tmp, list(kernels.values()),
                               {n for s in rec.spans for n in s})
        rec.complete = rec.trace.busy_s > 0 and all(
            rec.trace.kernels.get(sym, (0, 0.0))[0] == made[name] for name, sym in kernels.items())
    return rec


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float = None, genome_length=None) -> tuple:
    """One run: (the result line's dict, the numbers compared as
    {name: (value, limit)})."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        reads = generate.error_reads(cfg, seed, device, genome_length)
        host_reads = reads.cpu().numpy()
        del reads
        kind = job.load(traffic["entry"])
        work = kind.Job(cfg, traffic, host_reads, tmp, device)
        work.warmup(Spans(device, False).into({}))
        _sync(device)
        setup_peak = _peak(device)
        setup_s = time.perf_counter() - t_start

        kernels = {}
        for m in cell.per_layer if traced else []:
            if m["name"].endswith(roofline.SUFFIX):
                name = m["name"].removesuffix(roofline.SUFFIX)
                kernels[name] = roofline.kernel(name).KERNEL
        for _ in range(TRACE_TRIES if traced else 1):
            rec = window(work, seconds, device, traced, tmp, kernels)
            if not traced or rec.complete:
                break
            print("portbench: the trace lost device events; taking the window again",
                  file=sys.stderr)
        if traced and not rec.complete:
            raise RuntimeError(f"{TRACE_TRIES} traces of the window lost device events")
        memory_peak = max([setup_peak] + rec.peaks)

        # the program's outputs in the comparison's terms, then its state freed
        got = work.summarize(rec.out) if rec.out is not None else None
        rec.out = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = kind.reference(torch.from_numpy(host_reads).to(device), cfg)
        checks = work.check(got, ref) if got is not None else {"output": 1}
        want = kind.sizes(ref)
        checks["jobs"] = rec.failed + sum(p != want for p in rec.prints if p is not None)
        limits = {name: (int(v), 0) for name, v in checks.items()}
        correct = all(v <= lim for v, lim in limits.values())

        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ctx = types.SimpleNamespace(
            window_s=rec.window_s, jobs=rec.jobs, setup_s=setup_s, peaks=rec.peaks,
            spans=rec.spans, stats=rec.stats, trace=rec.trace, device_kind=kind,
            shape=roofline.shape_of(cfg, host_reads.shape[0], ref["table"]["distinct"]))
        metrics = {}
        for m in cell.per_layer if traced else cell.end_to_end:
            v = readers.load(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
               "count": cell.chips, "memory_peak_bytes": memory_peak}
        result = {"correct": correct, "attempted": rec.jobs, "failed": rec.failed,
                  "metrics": metrics, "device": dev}
        if traced:
            dev["busy_s"] = rec.trace.busy_s
            dev["window_s"] = rec.trace.window_s
            result["breakdown"] = {"device_ops": rec.trace.device_ops,
                                   "idle_gaps": rec.trace.idle_gaps}
        notes = {"tables": int(ref["table"]["codes"].shape[0]), "distinct": ref["table"]["distinct"],
                 "unitigs": ref["n_unitigs"], "tips": ref["n_tip_unitigs"],
                 "cleaned": ref["n_cleaned"], "cycle_kmers": ref["cycle_kmers"],
                 "one_sided_joins": ref["one_sided_joins"], "job_sizes": rec.prints[-1]}
        print("portbench reference: " + json.dumps(notes), file=sys.stderr)
        for i, (w, s, st) in enumerate(zip(rec.walls, rec.spans, rec.stats)):
            stages = {n: round(sum(v), 4) for n, v in st.items()
                      if n.endswith("_s") and isinstance(v, list)}
            print(f"portbench job {i}: {w:.4f} s, spans "
                  + json.dumps({n: round(v, 4) for n, v in s.items()}) + ", stages "
                  + json.dumps(stages), file=sys.stderr)
        result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in limits.items()}
        return result, limits
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: float = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result, limits = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: modules loaded that the benchmark must not load: {leaked}",
              file=sys.stderr)
        return 4
    for name, (v, lim) in limits.items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
