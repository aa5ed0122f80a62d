"""The streamed deployment's job on the port, on the CPU at a small genome.

A FASTQ file of the configuration's error reads streamed in 64 packed blocks
into ``filter_kmers_streaming(merge="device")`` and assembled
(``portbench/jobs/streamed.py``), compared with the plain reference
(``portbench/reference.py``); the control; a dropped chunk; the stages and
the counters the streamed count records.  The port alone: no JAX."""

import contextlib
import copy
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from portbench import control, generate, harness, job, readers
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import stages

CPU = "cpu"
GENOME = 20_000  # bases, as portbench/tests/conftest.py's SMALL_GENOME: 4,000 reads
CELL = "ecoli_err_k31.streamed"
SEED = 2**31 + 2**30 + 12345  # wider than 32 signed bits
KIND = job.load("streamed")
METRICS = ("streamed.read_s", "streamed.count_s", "streamed.merge_s", "streamed.merge_rows_M")


def cell_config(k: int) -> dict:
    cfg = copy.deepcopy(harness.load_cell(harness.ROOT, CELL).config)
    cfg["k"], cfg["tip_max_bases"] = k, 2 * k
    return cfg


def nospan(name):
    return contextlib.nullcontext()


def streamed_job(cfg, reads, tmp):
    return KIND.Job(cfg, harness.load_cell(harness.ROOT, CELL).traffic, reads.numpy(), str(tmp),
                    CPU)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: each test counts 64 small
    chunks, and a pool of a thread a core in each of several test processes
    on the same CPUs turns every small op into a wait for the pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def blocks():
    """Seed 7's reads at k 31 as 2-D blocks of 63 reads: 64 chunks."""
    reads = generate.error_reads(cell_config(31), 7, CPU, GENOME).numpy()
    return [(reads[lo : lo + 63], 0, 0) for lo in range(0, len(reads), 63)]


@pytest.mark.parametrize("k", [31, 21])
@pytest.mark.parametrize("seed", [SEED, 8])
def test_job_matches_reference(k, seed, tmp_path):
    cfg = cell_config(k)
    reads = generate.error_reads(cfg, seed, CPU, GENOME)
    work = streamed_job(cfg, reads, tmp_path)
    assert work.chunk == 63 and -(-len(reads) // work.chunk) == 64
    out = work.run(nospan, {})
    ref = KIND.reference(reads, cfg)
    checks = work.check(work.summarize(out), ref)
    assert set(checks) == {"table", "censor", "unitigs", "cleaned", "gfa"}
    assert all(v == 0 for v in checks.values()), checks
    assert out["sizes"] == KIND.sizes(ref)
    assert ref["n_tip_unitigs"] > 0 and ref["n_cleaned"] < ref["n_unitigs"]


def streamed(items, merge, stats, min_obs=2):
    t = TF.filter_kmers_streaming(items, 31, min_obs=min_obs, merge=merge,
                                  data_reduce="none" if merge == "device" else "label_first",
                                  chunk_reads=63, device=CPU, stats=stats)
    return [x.numpy() for x in (t.kmers, t.exts, t.counts, t.data)]


@pytest.mark.parametrize("merge", ["device", "host"])
def test_stats_leave_the_table_and_time_each_chunk(blocks, merge):
    stats = {}
    got = streamed(blocks, merge, stats)
    want = streamed(blocks, merge, None)
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    stages_s = {"stream.read_s", "stream.count_s", "stream.merge_s", "stream.finish_s"}
    assert set(stats) == stages_s | ({"stream.merge_rows"} if merge == "device" else set())
    assert [len(stats[n]) for n in sorted(stages_s)] == [64, 1, 64, 65]  # count finish merge read
    assert all(v >= 0 for n in stages_s for v in stats[n])


def test_merge_rows_are_the_counters(blocks):
    calls, rows = TF.merge_unique.calls, TF.merge_unique.rows
    stats = {}
    streamed(blocks, "device", stats)
    assert TF.merge_unique.calls - calls == 64
    assert sum(stats["stream.merge_rows"]) == TF.merge_unique.rows - rows > 0
    assert all(isinstance(r, int) for r in stats["stream.merge_rows"])
    # the table only grows: a merge that writes rows writes the table it leaves
    wrote = [r for r in stats["stream.merge_rows"] if r]
    assert wrote == sorted(wrote) and wrote[-1] == len(streamed(blocks, "device", None, 1)[0])


def no_stats(fn):
    """``fn`` with the call form of a program whose streamed count takes no
    ``stats``."""
    def filter_kmers_streaming(seqs, k, *, stranded=False, min_obs=1, data_reduce="label_first",
                               chunk_reads=4096, merge="host", device="cuda"):
        return fn(seqs, k, stranded=stranded, min_obs=min_obs, data_reduce=data_reduce,
                  chunk_reads=chunk_reads, merge=merge, device=device)
    return filter_kmers_streaming


@pytest.mark.parametrize("staged", [True, False])
def test_traced_job_reads_its_metrics_or_none(staged, tmp_path, monkeypatch):
    """Under a profiler the job passes ``stats`` and its readers read the
    stages; a program without ``stats=`` runs the same job, and every reader
    reads None."""
    monkeypatch.setattr(stages, "profiling", lambda: True)
    if not staged:
        monkeypatch.setattr(TF, "filter_kmers_streaming", no_stats(TF.filter_kmers_streaming))
        assert "stats" not in inspect.signature(TF.filter_kmers_streaming).parameters
    cfg = cell_config(31)
    reads = generate.error_reads(cfg, 9, CPU, GENOME)
    stats = {}
    out = streamed_job(cfg, reads, tmp_path).run(nospan, stats)
    assert out["sizes"] == KIND.sizes(KIND.reference(reads, cfg))
    ctx = types.SimpleNamespace(stats=[stats, {}])
    got = {m: readers.load(m).read(ctx) for m in METRICS}
    if staged:
        assert len(stats["stream.count_s"]) == len(stats["stream.merge_rows"]) == 64
        assert all(v > 0 for v in got.values()), got
        assert got["streamed.merge_rows_M"] == sum(stats["stream.merge_rows"]) / 1e6
    else:
        assert stats == {} and all(v is None for v in got.values()), got


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_control_reads_above_zero(seed):
    c = harness.load_cell(harness.ROOT, CELL)
    got = control.readings(c, generate.error_reads(c.config, seed, CPU, GENOME))
    assert got["cleaned"] > 0 and got["jobs"] == 1 and got["table"] > 0, got


def test_a_dropped_chunk_is_not_correct(monkeypatch):
    """One chunk's table of every job left out of the device table."""
    merge = TF.merge_unique
    calls = [0]

    def drop_sixth(*a):
        calls[0] += 1
        return a[:3] if calls[0] % 64 == 6 else merge(*a)
    monkeypatch.setattr(TF, "merge_unique", drop_sixth)
    c = harness.load_cell(harness.ROOT, CELL)
    result, limits = harness.run_cell(c, SEED, 0.05, False, CPU, genome_length=GENOME)
    assert not result["correct"] and limits["table"][0] > 0, limits


def test_cell_entries():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert w == {**w, "config": "ecoli_err_k31_streamed", "traffic": "streamed", "chips": 1}
    assert bench["workloads"][4] is w and len(w["why"]) <= 200  # appended after the colored cell
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    assert bench["configs"][3] is c and c["reduced"] == [] and len(c["why"]) <= 200
    (lib,) = [c for c in bench["configs"] if c["name"] == "ecoli_err_k31"]
    assert c["source"] != lib["source"]
    cfg, lib_cfg = (json.load(open(os.path.join(harness.ROOT, x["file"]))) for x in (c, lib))
    same = ("genome", "reads", "k", "stranded", "min_obs", "tip_max_bases", "assumed")
    assert [cfg[key] for key in same] == [lib_cfg[key] for key in same]  # the library cell's reads
    assert cfg["guarantees"][:-1] == lib_cfg["guarantees"]
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    spans = ("count_s", "compress_s", "graph_s")  # the harness's spans, as the library cell's
    at = bench["per_layer"].index(mine[3])  # the four appended together
    assert [m["name"] for m in mine] == list(spans + METRICS) and mine[3:] == bench["per_layer"][at : at + 4]
    assert all(m["workloads"][:2] == ["ecoli_err_k31.library", CELL] for m in mine[:3])
    assert all(m["moves"] == "assembly_s" and m["better"] == "lower" and m["workloads"] == [CELL]
               and m["source"] == "program_span" for m in mine[3:])
    assert [m["layer"] for m in mine[3:]] == ["io", "filter", "filter", "filter"]
    traffic = harness.load_cell(harness.ROOT, CELL).traffic
    assert (traffic["entry"], traffic["chunks"], traffic["merge"]) == ("streamed", 64, "device")
