"""Port parity for the policy layer: edge candidates and join masks,
compress_kmers under every named reduction, closure and CompressionSpec,
compress_kmers_no_exts, censored-extension repair, the pluggable
summarizers, and BaseGraph's rich sidecar.

The same numpy inputs go through the JAX package (on the CPU) and through
tpu_debruijn_torch (device="cpu"); tables cross by table_from_reference.
Outputs must be identical."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_colored import labeled_reads, port_table, same_nodes, same_table
from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import table_to_numpy

CPU = "cpu"


def _table(rng, k, stranded, min_obs=1, **kw):
    """A JAX table of labeled reads of random contigs, data = the first
    label of each kmer."""
    reads = labeled_reads(rng, n_labels=3, n_reads=40, read_len=64)
    return F.filter_kmers(reads, k, stranded=stranded, min_obs=min_obs, **kw)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _jax_edges(spec, stranded, candidates, kmers, exts, n, labels):
    return C.resolve_edges(spec, stranded, kmers, exts, n, labels, return_candidates=candidates)


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [16, 31, 47])
def test_resolve_edges_candidates_and_join_mask(rng, k, stranded):
    """The candidates before mutuality, and the edges with equality join
    labels, both with and without labels."""
    table = _table(rng, k, stranded)
    t = port_table(table)
    n = len(t)
    labels = rng.integers(0, 3, n).astype(np.int32)
    for candidates in (True, False):
        for lab in (None, labels):
            want = _jax_edges(C.KmerSpec(k), stranded, candidates, jnp.asarray(table.kmers),
                              jnp.asarray(table.exts), jnp.int32(n),
                              None if lab is None else jnp.asarray(lab))
            got = TC.resolve_edges(t.spec, stranded, t.kmers, t.exts,
                                   None if lab is None else torch.from_numpy(lab),
                                   return_candidates=candidates)
            assert got.keys() == want.keys()
            for key in want:
                assert np.array_equal(got[key].numpy(), np.asarray(want[key])), (key, candidates)
    # the join mask cut edges: fewer partners with labels than without
    plain = TC.resolve_edges(t.spec, stranded, t.kmers, t.exts)
    joined = TC.resolve_edges(t.spec, stranded, t.kmers, t.exts, torch.from_numpy(labels))
    assert (joined["partner_r"] >= 0).sum() < (plain["partner_r"] >= 0).sum()


POLICIES = {
    "sum_sat_u16": dict(),
    "sum": dict(data_reduce="sum"),
    "max": dict(data_reduce="max", data_field="data"),
    "min": dict(data_reduce="min", data_field="data"),
    "first": dict(data_reduce="first", data_field="data"),
    "join_on_data": dict(join_on_data=True, data_field="data", data_reduce="max"),
    "closure": dict(data_reduce=lambda a, b: (a * 3 + b) % 1009),
    "simple_closure": dict(spec_of=lambda M: M.SimpleCompress(lambda a, b: max(a, b) + 1)),
    "simple_named": dict(spec_of=lambda M: M.SimpleCompress("min"), data_field="data"),
    "scmap": dict(spec_of=lambda M: M.ScmapCompress(), data_field="data"),
    "label_fn": dict(spec_of=lambda M: M.CompressionSpec("sum", join_labels=lambda d: d % 2),
                     data_field="data"),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("k,stranded", [(16, False), (31, True)])
def test_compress_kmers_policies(rng, k, stranded, policy):
    table = _table(rng, k, stranded, min_obs=1)
    kw = dict(POLICIES[policy])
    spec_of = kw.pop("spec_of", None)
    want = C.compress_kmers(table, spec=spec_of and spec_of(C), **kw)
    got = TC.compress_kmers(port_table(table), spec=spec_of and spec_of(TC), device=CPU, **kw)
    same_nodes(got, want)
    assert len(got) > 1


@pytest.mark.parametrize("with_data", [False, True])
@pytest.mark.parametrize("k,stranded", [(16, False), (31, True), (47, False)])
def test_compress_kmers_no_exts(rng, k, stranded, with_data):
    """A kmer set with duplicates, shuffled: the first duplicate's data
    stays, the exts are inferred from membership."""
    table = _table(rng, k, stranded)
    kmers = np.asarray(table.kmers)
    idx = rng.permutation(np.concatenate([np.arange(len(kmers)), rng.integers(0, len(kmers), 30)]))
    data = rng.integers(0, 4, len(idx)).astype(np.int32) if with_data else None
    kw = dict(stranded=stranded, data_reduce="max", join_on_data=with_data)
    want = C.compress_kmers_no_exts(k, kmers[idx], data, **kw)
    got = TC.compress_kmers_no_exts(k, kmers[idx], data, device=CPU, **kw)
    same_nodes(got, want)
    assert TC.compress_kmers_no_exts(k, np.zeros((0, TC.KmerSpec(k).w), np.uint32), device=CPU) == []
    # infer_exts_device alone, against the JAX package's
    t = port_table(table)
    want_e = C._infer_exts_jit(C.KmerSpec(k), stranded, jnp.asarray(kmers), jnp.int32(len(kmers)))
    assert np.array_equal(TC.infer_exts_device(t.spec, stranded, t.kmers).numpy(), np.asarray(want_e))


@partial(jax.jit, static_argnums=(0, 1))
def _jax_censor(spec, stranded, kmers, exts, census):
    """The JAX package's remove_censored_exts(_sharded) on a table: its
    device function, compiled (the host API runs it op by op)."""
    return F.remove_censored_exts_device(
        spec, stranded, kmers, exts, jnp.int32(kmers.shape[0]), census,
        None if census is None else jnp.int32(census.shape[0]))


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [16, 31])
def test_remove_censored_exts(rng, k, stranded):
    """Global and sharded repair on a min_obs=2 table with its census."""
    reads = labeled_reads(rng, n_reads=20)
    table = F.filter_kmers(reads, k, stranded=stranded, min_obs=2, report_all=True)
    got = TF.filter_kmers(reads, k, stranded=stranded, min_obs=2, report_all=True, device=CPU)
    assert np.array_equal(table_to_numpy(got)["all_kmers"], table.all_kmers)
    for census, tfn in ((None, TF.remove_censored_exts),
                        (table.all_kmers, TF.remove_censored_exts_sharded)):
        want = np.asarray(_jax_censor(table.spec, stranded, jnp.asarray(table.kmers),
                                      jnp.asarray(table.exts),
                                      None if census is None else jnp.asarray(census)))
        t = TF.KmerTable(got.spec, stranded, got.kmers, got.exts.clone(), got.counts, got.data,
                         all_kmers=got.all_kmers)
        tfn(t, device=CPU)
        same_table(t, F.KmerTable(table.spec, stranded, table.kmers, want, table.counts, table.data))
        assert not np.array_equal(want, table.exts)  # something was censored
    got.all_kmers = None
    with pytest.raises(ValueError):
        TF.remove_censored_exts_sharded(got, device=CPU)


class TwoColor(TF.KmerSummarizer, F.KmerSummarizer):
    """Valid iff seen with two labels or more; data = the greatest label;
    exts the OR over observations of the odd labels only (so the order of
    observations and payloads matters)."""

    def summarize(self, kmer, exts, payloads):
        assert kmer.dtype == np.uint32 and len(exts) == len(payloads)
        odd = [int(e) for e, p in zip(exts, payloads) if p % 2]
        return len(set(payloads)) >= 2, int(np.bitwise_or.reduce(odd + [0])), max(payloads)


class FirstPayloads(TF.KmerSummarizer, F.KmerSummarizer):
    """Every kmer; data = its first three payloads in order, a tuple."""

    def summarize(self, kmer, exts, payloads):
        return True, int(np.bitwise_or.reduce(exts)), tuple(payloads[:3])


SUMMARIZERS = {
    "count": lambda M: M.CountFilter(2),
    "set": lambda M: M.CountFilterSet(1),
    "eq_class": lambda M: M.CountFilterEqClass(2),
    "custom": lambda M: TwoColor(),
    "payload_order": lambda M: FirstPayloads(),
}


@pytest.mark.parametrize("report_all", [False, True])
@pytest.mark.parametrize("name", sorted(SUMMARIZERS))
def test_filter_kmers_with_summarizer(rng, name, report_all):
    reads = labeled_reads(rng, n_labels=3, n_reads=30, read_len=50)
    stranded = name == "set"
    jsum, tsum = SUMMARIZERS[name](F), SUMMARIZERS[name](TF)
    want, wd = F.filter_kmers_with_summarizer(reads, 16, jsum, stranded=stranded,
                                              report_all=report_all)
    got, gd = TF.filter_kmers_with_summarizer(reads, 16, tsum, stranded=stranded,
                                              report_all=report_all, device=CPU)
    same_table(got, want)
    assert gd == wd and len(gd) > 0
    if report_all:
        assert np.array_equal(table_to_numpy(got)["all_kmers"], want.all_kmers)
    else:
        assert got.all_kmers is None
    if name == "eq_class":
        assert tsum.eq_classes == jsum.eq_classes
    empty, none = TF.filter_kmers_with_summarizer([(np.zeros(3, np.uint8), 0, 0)], 16, tsum,
                                                  device=CPU)
    assert len(empty) == 0 and none == []


def test_graph_rich_sidecar(rng, tmp_path):
    """Rich payloads ride BaseGraph as in the JAX package: from
    compress_kmers_rich output, through combine, add and add_flat, and
    into the finished graph; GFA bytes are unchanged by them."""
    reads = labeled_reads(rng, n_labels=3, n_reads=30)
    table, sets = F.filter_kmers_set(reads, 16)
    nodes = C.compress_kmers_rich(table, sets, reduce=lambda a, b: tuple(sorted(set(a) | set(b))))
    want = G.from_compress_output(16, False, nodes)
    got = TG.from_compress_output(16, False, nodes)
    assert got.rich == want.rich and len(got.rich) == len(got) > 1
    assert np.array_equal(got.data, want.data) and not got.data.any()
    comb, wcomb = TG.BaseGraph.combine([got, got]), G.BaseGraph.combine([want, want])
    assert comb.rich == wcomb.rich == got.rich + got.rich
    for g in (comb, wcomb):
        g.add(np.zeros(20, np.uint8), 0, 1)
        g.add_flat(np.zeros(40, np.uint8), [20, 20], [0, 0], rich=["a", {"b": 1}])
        g.add_flat(np.zeros(20, np.uint8), [20], [0])
    assert comb.rich == wcomb.rich and comb.rich[-4:] == [None, "a", {"b": 1}, None]
    assert TG.from_compress_output(16, False, C.compress_kmers(table)).rich is None
    plain = TG.BaseGraph(16, False)
    plain.add_flat(np.zeros(20, np.uint8), [20], [0])
    assert plain.rich is None
    with pytest.raises(ValueError):
        plain.add_flat(np.zeros(40, np.uint8), [20, 20], [0, 0], rich=["a"])
    dg = got.finish(device=CPU)
    assert dg.rich == got.rich
    dg.to_gfa(str(tmp_path / "torch.gfa"))
    want.finish().to_gfa(str(tmp_path / "jax.gfa"))
    assert (tmp_path / "torch.gfa").read_bytes() == (tmp_path / "jax.gfa").read_bytes()
