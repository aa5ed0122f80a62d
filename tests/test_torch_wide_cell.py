"""The wide-kmer deployment's job on the port, on the CPU at a small genome.

The library job at K 63 (four 32-bit limbs a kmer) and K 33 (three)
(``portbench/jobs/library_wide.py``), compared with the plain reference on
multi-word codes (``portbench/reference_wide.py``); that reference against
``portbench/reference.py`` at K 31; the control; the count of the binary
search over more than two limbs and the metric that reads it.  The port
alone: no JAX."""

import contextlib
import copy
import json
import math
import os
import types

import pytest
import torch

from portbench import control, generate, harness, job, readers
from portbench import reference as R
from portbench import reference_wide as RW
from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch import stages

CPU = "cpu"
GENOME = 20_000  # bases, as portbench/tests/conftest.py's SMALL_GENOME: 4,000 reads
CELL = "ecoli_err_k63.library"
SEED = 2**31 + 2**30 + 12345  # wider than 32 signed bits
KIND = job.load("library_wide")
METRICS = ("k63.censor_s", "k63.search_rows_M")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: a pool of a thread a core in
    each of several test processes on the same CPUs turns every small op
    into a wait for the pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cell_at(k: int):
    cell = copy.deepcopy(harness.load_cell(harness.ROOT, CELL))
    cell.config["k"], cell.config["tip_max_bases"] = k, 2 * k
    return cell


@pytest.mark.parametrize("k", [63, 33])
def test_run_is_correct(k):
    result, limits = harness.run_cell(cell_at(k), SEED, 0.05, False, CPU, genome_length=GENOME)
    assert set(limits) == {"table", "censor", "unitigs", "cleaned", "gfa", "jobs"}
    assert result["correct"] and result["failed"] == 0, limits
    assert all(v == 0 and lim == 0 for v, lim in limits.values())


def sides(rows: torch.Tensor) -> torch.Tensor:
    """Rows of (code, d) pairs -> rows of ``2 * code + d``, reference.py's sides."""
    return 2 * rows[:, 0::2] + rows[:, 1::2]


def test_reference_wide_equals_reference_at_k31():
    """Two codings, one answer: one 31-base word is reference.py's code."""
    cfg = cell_at(31).config
    reads = generate.error_reads(cfg, 5, CPU, GENOME)
    a, b = R.assemble(reads, cfg, censor=True), RW.assemble(reads, cfg, censor=True)
    assert b["table"]["codes"].shape[1] == 1
    assert torch.equal(a["table"]["codes"], b["table"]["codes"][:, 0])
    for key in ("counts", "exts"):
        assert torch.equal(a["table"][key], b["table"][key]), key
    assert a["table"]["distinct"] == b["table"]["distinct"]
    assert torch.equal(a["censored_exts"], b["censored_exts"])
    for u in ("unitigs", "cleaned"):
        assert torch.equal(a[u]["kmers"], b[u]["kmers"][:, 0])
        assert torch.equal(a[u]["links"], sides(b[u]["links"]))
        assert torch.equal(a[u]["ends"], torch.cat([sides(b[u]["ends"][:, :2]),
                                                    b[u]["ends"][:, 2:]], 1))
    assert torch.equal(a["edges"], sides(b["edges"]))
    for key in ("n_unitigs", "n_tip_unitigs", "n_cleaned", "cycle_kmers", "one_sided_joins"):
        assert a[key] == b[key], key
    assert a["n_tip_unitigs"] > 0 and a["n_cleaned"] < a["n_unitigs"]


def test_control_reads_above_zero():
    c = harness.load_cell(harness.ROOT, CELL)
    got = control.readings(c, generate.error_reads(c.config, 3, CPU, GENOME))
    assert set(got) == {"table", "censor", "unitigs", "cleaned", "gfa", "jobs"}
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_wide_rows_count_the_rounds(w):
    gen = torch.Generator().manual_seed(w)
    table = torch.unique(torch.randint(0, 6, (1000, w), generator=gen), dim=0)
    queries = torch.randint(0, 6, (500, w), generator=gen)
    before = S.searchsorted_limbs.wide_rows
    idx, found = S.searchsorted_limbs(table, queries)
    n = table.shape[0]
    want = 500 * math.ceil(math.log2(n + 1)) if w > 2 else 0
    assert S.searchsorted_limbs.wide_rows - before == want
    below = (S.lex_lt(table[None], queries[:, None]).sum(1))  # rows less than each query
    assert torch.equal(idx, below)
    assert torch.equal(found, (table[None] == queries[:, None]).all(2).any(1))


def nospan(name):
    return contextlib.nullcontext()


@pytest.mark.parametrize("counted", [True, False])
def test_traced_job_reads_its_metric_or_none(counted, tmp_path, monkeypatch):
    """Under a profiler the job passes ``stats`` and records the wide
    search's rows; a program without the counter runs the same job, and
    ``k63.search_rows_M`` reads None."""
    monkeypatch.setattr(stages, "profiling", lambda: True)
    if not counted:
        search = S.searchsorted_limbs
        monkeypatch.setattr(S, "searchsorted_limbs", lambda *a: search(*a))
        assert not hasattr(S.searchsorted_limbs, "wide_rows")
    c = harness.load_cell(harness.ROOT, CELL)
    reads = generate.error_reads(c.config, 9, CPU, GENOME)
    stats = {}
    work = KIND.Job(c.config, c.traffic, reads.numpy(), str(tmp_path), CPU)
    out = work.run(nospan, stats)
    assert out["sizes"][0] > 0 and {"filter.pad_s", "clean.compress_graph_s"} <= set(stats)
    ctx = types.SimpleNamespace(stats=[stats, {}], spans=[{"censor": 0.5}])
    got = {m: readers.load(m).read(ctx) for m in METRICS}
    assert got["k63.censor_s"] == 0.5
    if counted:
        # the censor alone searches 8 candidates a table kmer
        n = out["sizes"][0]
        assert stats["search.wide_rows"] >= 8 * n * math.ceil(math.log2(n + 1))
        assert got["k63.search_rows_M"] == stats["search.wide_rows"] / 1e6
    else:
        assert "search.wide_rows" not in stats and got["k63.search_rows_M"] is None


def test_cell_entries():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert w == {**w, "config": "ecoli_err_k63", "traffic": "library_wide", "chips": 1}
    assert len(w["why"]) <= 200
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    assert c["reduced"] == [] and c["source"].startswith("https://github.com/10XGenomics/")
    (lib,) = [c for c in bench["configs"] if c["name"] == "ecoli_err_k31"]
    cfg, lib_cfg = (json.load(open(os.path.join(harness.ROOT, x["file"]))) for x in (c, lib))
    same = ("genome", "reads", "stranded", "min_obs")
    assert [cfg[key] for key in same] == [lib_cfg[key] for key in same]  # the library cell's reads
    assert (cfg["k"], cfg["tip_max_bases"]) == (63, 126)
    mine = {m["name"]: m for m in bench["per_layer"] if CELL in m.get("workloads", [])}
    assert set(mine) == {"count_s", "compress_s", "graph_s", "extract_canonical_roofline",
                         "run_reduce_rows_roofline", *METRICS}
    assert all(mine[m]["workloads"][-1] == CELL for m in mine)
    assert [m["name"] for m in bench["per_layer"][-2:]] == list(METRICS)
    assert all(mine[m]["workloads"] == [CELL] and mine[m]["moves"] == "assembly_s"
               and mine[m]["layer"] == "filter" for m in METRICS)
    assert harness.load_cell(harness.ROOT, CELL).traffic["entry"] == "library_wide"
