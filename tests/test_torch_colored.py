"""Port parity for the colored path: label sets, eq classes, color-set and
rich compression, and the whole slice from labeled reads to GFA bytes.

The same numpy reads go through the JAX package (on the CPU) and through
tpu_debruijn_torch (device="cpu"); tables, pair labels, splits, eq-class
ids, unitig lists, color sets and payloads must be identical."""

import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn.oracle import ref as O
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import table_from_reference, table_to_numpy

CPU = "cpu"


def labeled_reads(rng, n_labels=4, n_reads=30, read_len=60, neg=False):
    """Reads of random contigs with embedded palindromes, half reverse
    complemented, each with a label in [0, n_labels) (shifted to start at
    -1 with ``neg``)."""
    pool = [np.asarray(c, np.uint8) for c in O.simple_random_contigs(rng) if len(c) >= read_len]
    reads = []
    for _ in range(n_reads):
        c = pool[int(rng.integers(0, len(pool)))]
        s = int(rng.integers(0, len(c) - read_len + 1))
        r = c[s : s + read_len].copy()
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append((r, 0, int(rng.integers(0, n_labels)) - int(neg)))
    return reads


def same_table(got, want) -> None:
    g = table_to_numpy(got)
    for f in ("kmers", "exts", "counts", "data"):
        assert np.array_equal(g[f], np.asarray(getattr(want, f)).astype(g[f].dtype)), f


def same_nodes(got, want) -> None:
    assert len(got) == len(want)
    for (gs, ge, gd), (ws, we, wd) in zip(got, want):
        assert np.array_equal(gs, ws) and ge == we and gd == wd


def port_table(t):
    return table_from_reference(t.spec.k, t.stranded, t.kmers, t.exts, t.counts, t.data, device=CPU)


@pytest.mark.parametrize("k,stranded,min_obs,neg", [
    (16, False, 1, False), (16, True, 1, False), (31, False, 2, True), (47, False, 1, False),
])
def test_set_filters_match_jax(rng, k, stranded, min_obs, neg):
    """filter_kmers_set_arrays, filter_kmers_set and filter_kmers_eq_classes:
    tables, pair labels (a negative color sorts last), splits, tuples and
    eq-class ids."""
    reads = labeled_reads(rng, neg=neg)
    kw = dict(stranded=stranded, min_obs=min_obs)
    want, wl, ws = F.filter_kmers_set_arrays(reads, k, **kw)
    got, gl, gs = TF.filter_kmers_set_arrays(reads, k, device=CPU, **kw)
    assert len(want) > 10
    same_table(got, want)
    assert gl.dtype == torch.int32 and gs.dtype == torch.int64
    assert np.array_equal(gl.numpy(), wl) and np.array_equal(gs.numpy(), ws)
    assert (gl < 0).any() == neg

    got_t, got_sets = TF.filter_kmers_set(reads, k, device=CPU, **kw)
    want_t, want_sets = F.filter_kmers_set(reads, k, **kw)
    same_table(got_t, want_t)
    assert got_sets == want_sets

    got_e, got_classes = TF.filter_kmers_eq_classes(reads, k, device=CPU, **kw)
    want_e, want_classes = F.filter_kmers_eq_classes(reads, k, **kw)
    same_table(got_e, want_e)
    assert got_classes == want_classes


def test_set_filters_empty():
    reads = [(np.zeros(5, np.uint8), 0, 1)]
    t, pl, sp = TF.filter_kmers_set_arrays(reads, 16, device=CPU)
    assert len(t) == 0 and pl.shape == (0,) and sp.tolist() == [0]
    assert TF.filter_kmers_set(reads, 16, device=CPU)[1] == []
    assert TF.filter_kmers_eq_classes(reads, 16, device=CPU)[1] == []


def long_runs(rng, n=300):
    """(pair_kmer, pair_label, n) with runs up to 70 labels drawn from a few
    sets of labels across the whole int32 range, so the digests' powers and
    sums wrap many times and equal sets recur."""
    sets = [np.unique(rng.integers(-(1 << 31), 1 << 31, int(rng.integers(0, 70))).astype(np.int32))
            for _ in range(12)]
    picks = rng.integers(0, len(sets), n)
    pk = np.concatenate([np.full(len(sets[p]), i, np.int32) for i, p in enumerate(picks)])
    return pk, np.concatenate([sets[p] for p in picks]), n


@pytest.mark.parametrize("dense_limit", [1 << 40, 0])
def test_assign_eq_classes_dense_and_hashed(rng, dense_limit):
    """Both forms (the hashed one forced by dense_limit=0) against the JAX
    package's, on the pairs of a colored table and on empty runs."""
    reads = labeled_reads(rng, n_labels=5, n_reads=60)
    table, pair_label, split = F.filter_kmers_set_arrays(reads, 16)
    n = len(table)
    pair_kmer = np.repeat(np.arange(n), np.diff(split)).astype(np.int32)
    cases = [(pair_kmer, pair_label, n),
             (np.array([0, 0, 2, 2, 4], np.int32), np.array([1, 2, 1, 2, 3], np.int32), 5),
             (np.zeros(0, np.int32), np.zeros(0, np.int32), 3),
             # a label -1: the JAX package's dense rows pad with -1
             (np.array([0, 0, 1, 2], np.int32), np.array([3, -1, 3, -1], np.int32), 4),
             long_runs(rng)]
    for pk, pl, m in cases:
        got = TF.assign_eq_classes(pk, pl, m, dense_limit=dense_limit, device=CPU)
        want = F.assign_eq_classes(pk, pl, m, dense_limit=dense_limit)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.int32
        assert got[1] == want[1]


@pytest.mark.parametrize("join_on_sets", [False, True])
@pytest.mark.parametrize("k,stranded", [(16, False), (16, True), (31, False)])
def test_color_sets_match_jax(rng, k, stranded, join_on_sets):
    reads = labeled_reads(rng, n_labels=3, n_reads=40)
    want_t, wl, ws = F.filter_kmers_set_arrays(reads, k, stranded=stranded)
    got_t, gl, gs = TF.filter_kmers_set_arrays(reads, k, stranded=stranded, device=CPU)
    want = C.compress_kmers_color_sets(want_t, wl, ws, join_on_sets=join_on_sets)
    got = TC.compress_kmers_color_sets(got_t, gl, gs, join_on_sets=join_on_sets, device=CPU)
    same_nodes(got[0], want[0])
    assert len(got[0]) > 1
    assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int32
    assert np.array_equal(got[2], want[2]) and got[2].dtype == np.int64
    # numpy pair arrays give the same
    again = TC.compress_kmers_color_sets(got_t, wl, ws, join_on_sets=join_on_sets, device=CPU)
    same_nodes(again[0], want[0])


def test_color_sets_empty_table():
    t, pl, sp = TF.filter_kmers_set_arrays([(np.zeros(3, np.uint8), 0, 0)], 16, device=CPU)
    nodes, labels, split = TC.compress_kmers_color_sets(t, pl, sp, device=CPU)
    assert nodes == [] and labels.shape == (0,) and split.tolist() == [0]


class NearJoin:
    """A symmetric non-equality join test (test_rich_data.py)."""

    def reduce(self, a, b):
        return min(a, b)

    def join_test(self, d1, d2):
        return abs(d1 - d2) <= 1


@pytest.mark.parametrize("form", ["union", "near_join", "default_reduce"])
def test_rich_matches_jax(rng, form):
    """compress_kmers_rich with a union closure over label tuples, a
    non-equality join_test spec, and no reduce (the first payload)."""
    reads = labeled_reads(rng, n_labels=5, n_reads=36)
    table, sets = F.filter_kmers_set(reads, 16)
    t = port_table(table)
    union = lambda a, b: tuple(sorted(set(a) | set(b)))
    if form == "union":
        want = C.compress_kmers_rich(table, sets, reduce=union)
        got = TC.compress_kmers_rich(t, sets, reduce=union, device=CPU)
    elif form == "near_join":
        payloads = [min(s) for s in sets]
        want = C.compress_kmers_rich(table, payloads, spec=NearJoin())
        got = TC.compress_kmers_rich(t, payloads, spec=NearJoin(), device=CPU)
        assert len(got) > len(C.compress_kmers(table))  # the join test broke chains
    else:
        want = C.compress_kmers_rich(table, sets)
        got = TC.compress_kmers_rich(t, sets, device=CPU)
    same_nodes(got, want)


def test_color_sets_equal_rich_union(rng):
    """The array path's per-unitig unions equal the rich object path's."""
    reads = labeled_reads(rng, n_labels=4, n_reads=40)
    table, sets = TF.filter_kmers_set(reads, 16, device=CPU)
    t2, pl, sp = TF.filter_kmers_set_arrays(reads, 16, device=CPU)
    rich = TC.compress_kmers_rich(table, sets, reduce=lambda a, b: tuple(sorted(set(a) | set(b))),
                                  device=CPU)
    nodes, labels, split = TC.compress_kmers_color_sets(t2, pl, sp, device=CPU)
    assert [(s.tolist(), e, tuple(labels[split[u] : split[u + 1]].tolist()))
            for u, (s, e, _) in enumerate(nodes)] == [(s.tolist(), e, d) for s, e, d in rich]


def _flat(nodes):
    return (np.concatenate([s for s, _, _ in nodes]).astype(np.uint8),
            np.array([len(s) for s, _, _ in nodes], np.int64),
            np.array([e for _, e, _ in nodes], np.int32), np.array([d for _, _, d in nodes], np.int32))


@pytest.mark.parametrize("join_on_sets", [False, True])
def test_colored_slice_gfa_identical(rng, tmp_path, join_on_sets):
    """Labeled reads -> filter_kmers_set_arrays -> compress_kmers_color_sets
    -> from_flat_output(...).finish().to_gfa: the GFA bytes of both
    packages are equal."""
    reads = labeled_reads(rng, n_labels=3, n_reads=40)
    t, pl, sp = F.filter_kmers_set_arrays(reads, 31, min_obs=1)
    nodes = C.compress_kmers_color_sets(t, pl, sp, join_on_sets=join_on_sets)[0]
    G.from_flat_output(31, False, *_flat(nodes)).finish().to_gfa(str(tmp_path / "jax.gfa"))

    tt, tpl, tsp = TF.filter_kmers_set_arrays(reads, 31, min_obs=1, device=CPU)
    tnodes = TC.compress_kmers_color_sets(tt, tpl, tsp, join_on_sets=join_on_sets, device=CPU)[0]
    g = TG.from_flat_output(31, False, *_flat(tnodes))
    g.finish(device=CPU).to_gfa(str(tmp_path / "torch.gfa"))
    want = (tmp_path / "jax.gfa").read_bytes()
    assert (tmp_path / "torch.gfa").read_bytes() == want
    assert want.count(b"\nS\t") == len(g) > 1 and b"\nL\t" in want
