"""The colored deployment's job on the port, on the CPU at a small genome.

Four labelled strains (:mod:`portbench.strains`, 15x each, the
configuration's error model) through the benchmark's colored job
(``portbench/jobs/colored.py``: the colored count, the censor, the set join,
the graph, ``clean_tips`` under ``ScmapCompress`` and the tagged GFA),
compared with the plain colored reference (``portbench/reference_colored.py``);
the control; ``clean_tips(spec=)`` against its parts; the stages and the
counters the colored path records.  The port alone: no JAX."""

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench import compare as CP
from portbench import generate, harness, job
from portbench import reference as R
from tpu_debruijn_torch import clean as TCL
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG

CPU = "cpu"
GENOME = 30_000  # bases an ancestor: 12,000 reads over four strains
CELL = "strains4_err_k31.colored"


def cell_config(k: int) -> dict:
    cfg = copy.deepcopy(harness.load_cell(harness.ROOT, CELL).config)
    cfg["k"], cfg["tip_max_bases"] = k, 2 * k
    return cfg


KIND = job.load("colored")


def nospan(name):
    return contextlib.nullcontext()


@pytest.fixture(scope="module")
def strain_items():
    """The labelled reads of seed 7's strains at k 31, as job items."""
    cfg = cell_config(31)
    reads = generate.error_reads(cfg, 7, CPU, GENOME).numpy()
    work = KIND.Job(cfg, harness.load_cell(harness.ROOT, CELL).traffic, reads, "/nonexistent", CPU)
    return work.items


@pytest.mark.parametrize("k", [31, 21])
@pytest.mark.parametrize("seed", [2**31 + 2**30 + 5, 8])
def test_job_matches_reference(k, seed, tmp_path):
    cfg = cell_config(k)
    reads = generate.error_reads(cfg, seed, CPU, GENOME)
    work = KIND.Job(cfg, harness.load_cell(harness.ROOT, CELL).traffic, reads.numpy(),
                    str(tmp_path), CPU)
    out = work.run(nospan, {})
    ref = KIND.reference(reads, cfg)
    checks = work.check(work.summarize(out), ref)
    assert set(checks) == {"table", "sets", "censor", "unitigs", "unitig_sets", "cleaned", "gfa"}
    assert all(v == 0 for v in checks.values()), checks
    assert out["sizes"] == KIND.sizes(ref)
    # the deployment's shape: sets of every size, tips removed, tags on every segment
    sets = ref["table"]["sets"]
    assert {int(m) for m in sets.unique()} >= {1, 2, 4, 8, 15}
    assert ref["n_tip_unitigs"] > 0 and ref["n_cleaned"] < ref["n_unitigs"]
    assert (KIND.tag_masks(work.gfa) > 0).all()


@pytest.mark.parametrize("seed", [3, 4, 2**31 + 11])
def test_control_reads_above_zero(seed):
    cfg = cell_config(31)
    got = KIND.control(cfg, generate.error_reads(cfg, seed, CPU, GENOME))
    assert got["sets"] > 0 and got["unitigs"] > 0, got
    assert got["table"] == 0 and got["censor"] == 0


def kmer_classes(items, k):
    """The table, and each table kmer's eq-class id by its code."""
    table, pair_label, split = TF.filter_kmers_set_arrays(items, k, min_obs=2, device=CPU)
    TF.remove_censored_exts(table, device=CPU)
    ids = TF.eq_class_ids(pair_label, split)[0]
    return table, pair_label, split, CP.limb_codes(table.kmers), ids.to(torch.int64)


def node_classes(graph, codes, ids, k):
    """(each kmer's node, the eq-class id of that kmer) over the graph."""
    seqs = graph.base.sequences
    t = lambda a: torch.as_tensor(np.asarray(a))
    node, _, fwd, _ = CP.node_kmers(t(seqs._flat()).to(torch.uint8), t(seqs.start).long(),
                                    t(seqs.length).long(), k)
    canon = torch.minimum(fwd, R.rc_codes(fwd, k))
    at = torch.searchsorted(codes, canon)
    assert torch.equal(codes[at], canon)
    return node, ids[at]


def tip(node) -> bool:
    return node.len() < 62


def colored_graph(items):
    table, pair_label, split, codes, ids = kmer_classes(items, 31)
    nodes, _, _ = TC.compress_kmers_color_sets(table, pair_label, split, join_on_sets=True,
                                               device=CPU)
    return (lambda: TG.from_compress_output(31, False, nodes).finish(device=CPU)), codes, ids


@pytest.mark.parametrize("spec", ["scmap", None])
def test_clean_tips_joins_only_equal_classes(strain_items, spec):
    """Under ScmapCompress every cleaned node holds kmers of one eq class,
    its data; the default policy does join across classes here."""
    graph, codes, ids = colored_graph(strain_items)
    g = graph()
    policy = TC.ScmapCompress() if spec else None
    cleaned = TCL.clean_tips(g, tip, spec=policy, device=CPU)
    node, cls = node_classes(cleaned, codes, ids, 31)
    per_node = lambda op: torch.zeros(len(cleaned), dtype=torch.int64).scatter_reduce_(
        0, node, cls, op, include_self=False)
    mixed = per_node("amax") != per_node("amin")
    if spec:
        assert not bool(mixed.any())
        assert torch.equal(torch.as_tensor(np.asarray(cleaned.data, np.int64))[node], cls)
    else:
        assert bool(mixed.any())


def test_clean_tips_spec_is_its_parts(strain_items, tmp_path):
    graph, _, _ = colored_graph(strain_items)
    a = TCL.clean_tips(graph(), tip, spec=TC.ScmapCompress(), device=CPU)
    g = graph()
    bad = TCL.CleanGraph(tip).find_bad_nodes(g)
    b = TG.compress_graph(g, censor_nodes=bad, spec=TC.ScmapCompress(), device=CPU)
    c = TCL.clean_tips(graph(), tip, device=CPU)
    d = TCL.clean_tips(graph(), tip, spec=None, device=CPU)
    out = []
    for i, x in enumerate((a, b, c, d)):
        x.to_gfa(str(tmp_path / f"{i}.gfa"))
        out.append(((tmp_path / f"{i}.gfa").read_bytes(), np.asarray(x.data).tolist()))
    assert out[0] == out[1] and out[2] == out[3] and out[0] != out[2]


SET_STAGES = ("filter.pad", "filter.upload", "filter.pairs", "filter.pair_table")
FOLD_STAGES = ("compress.eq_classes", "compress.nodes", "compress.fold_sets")


def colored_outputs(items, stats, join_on_sets=True):
    table, pair_label, split = TF.filter_kmers_set_arrays(items, 31, min_obs=2, device=CPU,
                                                          stats=stats)
    nodes, labels, out_split = TC.compress_kmers_color_sets(
        table, pair_label, split, join_on_sets=join_on_sets, device=CPU, stats=stats)
    return ([t.numpy() for t in (table.kmers, table.exts, table.counts, pair_label, split)],
            nodes, labels, out_split)


@pytest.mark.parametrize("join_on_sets", [True, False])
def test_stages_once_a_call_and_same_outputs(strain_items, join_on_sets):
    stats = {}
    got = colored_outputs(strain_items, stats, join_on_sets)
    want = colored_outputs(strain_items, None, join_on_sets)
    stages = SET_STAGES + (FOLD_STAGES if join_on_sets else FOLD_STAGES[1:])
    assert set(stats) == {s + "_s" for s in stages}
    assert all(len(v) == 1 and v[0] >= 0 for v in stats.values())
    assert all(np.array_equal(x, y) for x, y in zip(got[0], want[0]))
    assert len(got[1]) == len(want[1]) and all(
        np.array_equal(gs, ws) and ge == we and gd == wd
        for (gs, ge, gd), (ws, we, wd) in zip(got[1], want[1]))
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])


def test_counters_count(strain_items):
    rows, dense, hashed = (TF.count_kmer_pairs.rows, TF.eq_class_ids.dense_calls,
                           TF.eq_class_ids.hashed_calls)
    table, pair_label, split = TF.filter_kmers_set_arrays(strain_items, 31, min_obs=1, device=CPU)
    assert TF.count_kmer_pairs.rows - rows == pair_label.shape[0] > len(table)
    TF.eq_class_ids(pair_label, split)
    assert (TF.eq_class_ids.dense_calls - dense, TF.eq_class_ids.hashed_calls - hashed) == (1, 0)
    a = TF.eq_class_ids(pair_label, split, dense_limit=0)
    assert (TF.eq_class_ids.dense_calls - dense, TF.eq_class_ids.hashed_calls - hashed) == (1, 1)
    assert torch.equal(a[0], TF.eq_class_ids(pair_label, split)[0])


def test_empty_input_records_the_pad_stage():
    stats = {}
    table, pair_label, split = TF.filter_kmers_set_arrays([(np.zeros(5, np.uint8), 0, 1)], 31,
                                                          device=CPU, stats=stats)
    assert len(table) == 0 and pair_label.shape == (0,) and split.tolist() == [0]
    assert set(stats) == {"filter.pad_s"}


def test_cell_entries():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert w["chips"] == 1 and w["traffic"] == "colored"
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    assert sorted(m["name"] for m in mine) == sorted(
        ["strains4.pad_s", "strains4.pairs_s", "strains4.pair_table_s", "strains4.eq_classes_s",
         "strains4.fold_sets_s", "strains4.clean_s", "strains4.device_idle_pct"])
    assert all(m["moves"] == "assembly_s" for m in mine)
