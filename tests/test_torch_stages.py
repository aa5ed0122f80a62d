"""The port's stage tracer (``tpu_debruijn_torch.stages``) and the stages the
entry points record: the keys each call adds to ``stats`` (one entry a call,
each parent at least the sum of its children), the same outputs with and
without ``stats``, the ``tdb.*`` profiler marks nested in their parents'
with or without ``stats``, and nothing at all without either.  The port
alone, on the CPU, on a 3 kb genome."""

import json
import time

import numpy as np
import pytest
import torch

from tpu_debruijn_torch import assemble
from tpu_debruijn_torch import clean as TCL
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch import stages as ST

CPU = "cpu"
K, P = 31, 8

# the stages each entry point adds, and each parent's children
NEW = {
    "filter_kmers": {"filter.pad", "filter.upload"},
    "compress_kmers": {"compress.nodes"},
    "compress_kmers_flat_device": {"compress.nodes"},
    "clean_tips": {"clean.compress_graph"},
    "run": {"filter.pad", "filter.upload", "compress.nodes", "graph.add", "graph.finish",
            "clean.compress_graph"},
    "run_sharded": {"select_reads", "final.stitch", "final.finish", "clean.compress_graph"},
    "assemble_sharded": {"select_reads", "final.stitch", "final.finish"},
}
CHILDREN = {"count": ("filter.pad", "filter.upload"),
            "compress": ("compress.nodes", "graph.add", "graph.finish"),
            "clean_tips": ("clean.compress_graph",), "final": ("final.stitch", "final.finish")}
# the stages that were there before, with their entries a call
OLD = {
    "filter_kmers": {}, "compress_kmers": {}, "compress_kmers_flat_device": {}, "clean_tips": {},
    "run": {"read": 1, "count": 1, "compress": 1, "clean_tips": 1, "export": 1},
    "run_sharded": {"read": 1, "assemble_sharded": 1, "pad_reads": 1, "msp": 1, "exchange": 1,
                    "count": 8, "compress": 8, "stitch": 1, "gather": 1, "assemble": 1,
                    "final": 1, "clean_tips": 1, "export": 1},
    "assemble_sharded": {"pad_reads": 1, "msp": 1, "exchange": 1, "count": 8, "compress": 8,
                         "stitch": 1, "gather": 1, "assemble": 1, "final": 1},
}


@pytest.fixture(scope="module")
def reads():
    """A 3 kb random genome at ~25x in 100 bp reads, half reverse-
    complemented, one in 30 with a substitution (tips), and a few reads
    shorter than K."""
    rng = np.random.default_rng(16)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    out = []
    for i in range(760):
        s = int(rng.integers(0, len(genome) - 100))
        r = genome[s : s + 100].copy()
        if i % 30 == 7:
            r[int(rng.integers(40, 60))] ^= 1
        if i % 2:
            r = (3 - r[::-1]).astype(np.uint8)
        out.append(r[:20] if i % 97 == 3 else r)
    return out


@pytest.fixture(scope="module")
def fastq(reads, tmp_path_factory):
    path = tmp_path_factory.mktemp("stages") / "reads.fq"
    lines = []
    for i, r in enumerate(reads):
        seq = "".join("ACGT"[b] for b in r)
        lines += [f"@r{i}", seq, "+", "I" * len(seq)]
    path.write_text("\n".join(lines) + "\n")
    return path


def tip(node) -> bool:
    return node.len() < 2 * K


def gfa(graph, path) -> bytes:
    graph.to_gfa(str(path))
    return path.read_bytes()


def call(entry, reads, fastq, tmp_path, stats, tag="out"):
    """``entry`` run with ``stats``: what it made, as bytes or arrays."""
    if entry == "filter_kmers":
        t = TF.filter_kmers([(r, 0, 0) for r in reads], K, min_obs=2, device=CPU, stats=stats)
        return [x.numpy() for x in (t.kmers, t.exts, t.counts, t.data)]
    if entry in ("compress_kmers", "compress_kmers_flat_device", "clean_tips"):
        table = TF.filter_kmers([(r, 0, 0) for r in reads], K, min_obs=1, device=CPU)
        if entry == "compress_kmers":
            return TC.compress_kmers(table, device=CPU, stats=stats)
        if entry == "compress_kmers_flat_device":
            return list(TC.compress_kmers_flat_device(table, device=CPU, stats=stats))
        graph = TG.from_compress_output(K, False, TC.compress_kmers(table, device=CPU))
        return gfa(TCL.clean_tips(graph.finish(device=CPU), tip, device=CPU, stats=stats),
                   tmp_path / f"{tag}.gfa")
    if entry == "assemble_sharded":
        graph = TP.assemble_sharded(reads, K, P, min_obs=2, device=CPU, stats=stats)
        return gfa(graph, tmp_path / f"{tag}.gfa")
    out = tmp_path / f"{tag}.gfa"
    argv = [str(fastq), "-o", str(out), "--clean-tips", "--min-obs", "1", "--device", CPU]
    assemble.run(argv + (["--sharded", "-p", str(P)] if entry == "run_sharded" else []),
                 stats=stats)
    return out.read_bytes()


def same(a, b) -> bool:
    if isinstance(a, bytes):
        return a == b
    if isinstance(a[0], np.ndarray):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and x[1:] == y[1:] for x, y in zip(a, b))


@pytest.mark.parametrize("entry", sorted(NEW))
def test_stats_keys_and_outputs(entry, reads, fastq, tmp_path):
    """(a) the new stages, one entry a call, each parent at least the sum of
    its children; (b) the same outputs without ``stats``; (d) the stages
    that were there keep their entries a call."""
    stats = {}
    got = call(entry, reads, fastq, tmp_path, stats, "with")
    want = call(entry, reads, fastq, tmp_path, None, "without")
    assert same(got, want)
    seen = {n[:-2]: len(v) for n, v in stats.items() if n.endswith("_s")}
    assert seen == {**OLD[entry], **{n: 1 for n in NEW[entry]}}
    assert all(x >= 0 for n, v in stats.items() if n.endswith("_s") for x in v)
    for parent, kids in CHILDREN.items():
        if parent + "_s" in stats and kids[0] + "_s" in stats:
            assert sum(stats[parent + "_s"]) >= sum(sum(stats[c + "_s"]) for c in kids)


def marks(prof, path) -> list:
    """(name, start, end) of each mark in the trace as Chrome JSON, as the
    benchmark reads it."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def nested(child, parent, events) -> bool:
    ps = [e for e in events if e[0] == parent]
    return all(any(p[1] <= c[1] and c[2] <= p[2] for p in ps) for c in events if c[0] == child)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("entry", ["run", "run_sharded", "assemble_sharded"])
def test_profiler_marks_nest(entry, with_stats, reads, fastq, tmp_path):
    """(c) Under a profiler every stage is a ``tdb.`` mark inside its
    parent's (the caller's for a top stage), with or without ``stats``; the
    profiler leaves ``stats`` as a run without one fills it."""
    stats = {} if with_stats else None
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            call(entry, reads, fastq, tmp_path, stats)
    events = marks(prof, tmp_path / "trace.json")
    names = {e[0] for e in events}
    want = set(OLD[entry]) | NEW[entry]
    assert names == {"caller"} | {ST.PREFIX + n for n in want}
    for parent, kids in CHILDREN.items():
        for kid in kids:
            if kid in want:
                assert nested(ST.PREFIX + kid, ST.PREFIX + parent, events), kid
    for n in want:
        assert nested(ST.PREFIX + n, "caller", events)
    if entry == "run_sharded":
        for n in ("select_reads", "final.stitch", "final.finish"):
            assert nested(ST.PREFIX + n, ST.PREFIX + "assemble_sharded", events)
    if with_stats:
        plain = {}
        call(entry, reads, fastq, tmp_path, plain)
        assert {n: len(v) for n, v in stats.items() if n.endswith("_s")} == \
            {n: len(v) for n, v in plain.items() if n.endswith("_s")}


def test_nothing_without_profiler_or_stats(reads, fastq, tmp_path, monkeypatch):
    """(c) With no profiler and no ``stats``, no stage makes a mark, reads a
    clock or synchronizes, on a CUDA device too."""
    def refuse(*a, **kw):
        raise AssertionError("a stage did work with no profiler and no stats")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(ST.time, "perf_counter", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert not ST.profiling()
    ran = []
    with ST.Stages(None, "cuda")("x"):
        ran.append(1)
    assert ran == [1]
    monkeypatch.setattr(ST.time, "perf_counter", time.perf_counter)  # the CLI reads the clock
    call("run", reads, fastq, tmp_path, None)


def test_timed_stage_synchronizes_at_both_ends(monkeypatch):
    """With ``stats`` a stage on a CUDA device synchronizes before and
    after its body and appends one entry a call; an exception records
    nothing."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: syncs.append(str(d)))
    stats = {}
    stage = ST.Stages(stats, "cuda")
    for _ in range(2):
        with stage("x"):
            assert len(syncs) % 2 == 1
    assert syncs == ["cuda"] * 4 and len(stats["x_s"]) == 2
    with pytest.raises(ValueError):
        with stage("y"):
            raise ValueError
    assert "y_s" not in stats
