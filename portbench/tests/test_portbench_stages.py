"""The readers of the program's inner stages (``filter.*``, ``compress.nodes``,
``graph.*``, ``clean.compress_graph``, ``select_reads``, ``final.*``): each
the mean over the jobs of its summed stage seconds, None where no job has
the stage, and reported by a traced run of its cell."""

import types

import pytest

from conftest import SMALL_GENOME
from portbench import harness, readers, trace

SEED = 2**31 + 2**30 + 16  # wider than 32 signed bits

# metric -> (its cell, the stages it sums)
READS = {
    "pad_s.cli": ("ecoli_err_k31.cli", ("filter.pad",)),
    "upload_s.cli": ("ecoli_err_k31.cli", ("filter.upload",)),
    "node_loops_s.cli": ("ecoli_err_k31.cli", ("compress.nodes", "graph.add")),
    "graph_finish_s.cli": ("ecoli_err_k31.cli", ("graph.finish",)),
    "compress_graph_s.cli": ("ecoli_err_k31.cli", ("clean.compress_graph",)),
    "msp8.select_reads_s": ("ecoli_err_k31_msp8.sharded", ("select_reads",)),
    "msp8.host_stitch_s": ("ecoli_err_k31_msp8.sharded", ("final.stitch",)),
    "msp8.finish_s": ("ecoli_err_k31_msp8.sharded", ("final.finish",)),
}


def ctx(stats):
    return types.SimpleNamespace(stats=stats)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_sums_its_stages(name):
    _, stages = READS[name]
    jobs = [{s + "_s": [0.25 * (i + 1), 0.5] for s in stages} for i in range(3)]
    for job in jobs:
        job["count_s"] = [9.0]  # a stage the reader does not read
    want = sum(sum(0.25 * (i + 1) + 0.5 for _ in stages) for i in range(3)) / 3
    assert readers.load(name).read(ctx(jobs)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_without_its_stage_reads_nothing(name):
    _, stages = READS[name]
    other = {"count_s": [1.0], "read_s": [2.0], "pad_reads_s": [0.5], "final_s": [0.7]}
    assert readers.load(name).read(ctx([other, {}])) is None
    if len(stages) > 1:  # a job with only some of the stages is not read
        assert readers.load(name).read(ctx([{stages[0] + "_s": [1.0]}])) is None


def test_entries_name_their_cells():
    for name, (cell, _) in READS.items():
        c = harness.load_cell(harness.ROOT, cell)
        (m,) = [m for m in c.per_layer if m["name"] == name]
        assert m["source"] == "program_span" and m["moves"] == "assembly_s"
        assert m["workloads"] == [cell] and m["unit"] == "s"


@pytest.mark.parametrize("cell", sorted({c for c, _ in READS.values()}))
def test_traced_run_reports_them(cell, monkeypatch):
    def fake(prof, tmp, kernels, spans):
        return trace.Summary(busy_s=0.01, window_s=0.02, kernels={}, device_ops=[["k", 0.01]],
                             idle_gaps=[["count", 0.01]])
    monkeypatch.setattr(trace, "read", fake)
    c = harness.load_cell(harness.ROOT, cell)
    result, _ = harness.run_cell(c, SEED, 0.05, True, "cpu", genome_length=SMALL_GENOME)
    assert result["correct"]
    mine = {n for n, (w, _) in READS.items() if w == cell}
    got = result["metrics"]
    assert mine <= set(got)
    assert all(got[n]["value"] >= 0 and got[n]["unit"] == "s" for n in mine)
