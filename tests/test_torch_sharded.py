"""Port parity for the MSP-sharded assembly path (tpu_debruijn_torch.parallel)
and the graph functions it runs: per-shard tables and chains, both stitches
to GFA bytes, edge inputs (empty shards, skewed minimizers, the balancing
permutation), and compress_graph / fix_exts / clean_tips.

The same numpy reads go through the JAX package on the 8 virtual CPU
devices of tests/conftest.py and through the port on 8 logical shards
(device="cpu"); JAX's padded per-shard stacks are sliced by ``n_valid`` /
``n_unitigs``.  Graphs cross by convert.graph_from_reference.  Every JAX
shard_map shape compiles, so the JAX runs are shared at module scope."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn import clean as CL
from tpu_debruijn import msp as M
from tpu_debruijn.oracle import ref as O
from tpu_debruijn.parallel import assemble_sharded, make_mesh, sharded_tables
from tpu_debruijn.parallel.shard import _dest_histogram_fn
from tpu_debruijn_torch import clean as TCL
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import msp as TM
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch import table_to_numpy
from tpu_debruijn_torch.convert import graph_from_reference

CPU = "cpu"
K, P = 31, 8
REDUCES = ("label_first", "min", "max", "sum", "none")
CAP = 256  # JAX's exchange slots per (source, destination) pair


def contig_reads(rng, n_reads=100, read_len=60):
    """Reads of the reference's random contigs, half reverse-complemented,
    each read twice (so min_obs = 2 keeps every kmer a read saw)."""
    pool = [np.asarray(c, np.uint8) for c in O.random_contigs(rng) if len(c) >= read_len]
    reads = []
    for _ in range(n_reads):
        c = pool[int(rng.integers(0, len(pool)))]
        s = int(rng.integers(0, len(c) - read_len + 1))
        r = c[s : s + read_len].copy()
        reads.append((3 - r[::-1]).astype(np.uint8) if rng.random() < 0.5 else r)
    return reads + reads


@pytest.fixture(scope="module")
def reads():
    return contig_reads(np.random.default_rng(8))


@pytest.fixture(scope="module")
def labels(reads):
    return (np.arange(len(reads)) % 5 - 1).astype(np.int32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return TP.make_mesh(8, device=CPU)


def gfa_bytes(graph, path) -> bytes:
    graph.to_gfa(str(path))
    return path.read_bytes()


def canon_nodes(graph) -> list:
    out = []
    for i in range(len(graph)):
        b = graph.base.sequences.get_bases(i)
        out.append(min(tuple(b.tolist()), tuple((3 - b[::-1]).tolist())))
    return sorted(out)


_JAX_TABLES = {}


def jax_tables(reads, labels, mesh, data_reduce, min_obs):
    """JAX's sharded_tables, once a module for each (data_reduce, min_obs).
    An explicit cap_per_dest (above this input's need) spares the sizing
    pass its compile."""
    key = (data_reduce, min_obs)
    if key not in _JAX_TABLES:
        _JAX_TABLES[key] = sharded_tables(reads, K, P, min_obs=min_obs, mesh=mesh, labels=labels,
                                          data_reduce=data_reduce, cap_per_dest=CAP)
    return _JAX_TABLES[key]


@pytest.mark.parametrize("min_obs", [1, 2])
@pytest.mark.parametrize("data_reduce", REDUCES)
def test_sharded_tables_match_jax(reads, labels, mesh, tmesh, data_reduce, min_obs):
    """Per-shard tables (kmers, exts, counts, data), chains, unitig exts and
    contributed bases, bit for bit; no kmer in two shards."""
    plan, table, chains, u_exts, contrib = jax_tables(reads, labels, mesh, data_reduce, min_obs)
    tplan, tt, tc, tu, tcb = TP.sharded_tables(reads, K, P, min_obs=min_obs, mesh=tmesh,
                                               labels=labels, data_reduce=data_reduce, device=CPU)
    assert (tplan.k, tplan.p, tplan.min_obs, tplan.n_shards) == (K, P, min_obs, 8)
    assert len(tt) == len(tc) == len(tu) == len(tcb) == 8
    nv, nu = np.asarray(table.n_valid), np.asarray(chains.n_unitigs)
    assert (nv > 0).all()
    ja = lambda x, s, n: np.asarray(x)[s, :n]
    for s in range(8):
        n, u = int(nv[s]), int(nu[s])
        got = table_to_numpy(tt[s])
        assert np.array_equal(got["kmers"], ja(table.kmers, s, n))
        for f in ("exts", "counts", "data"):
            assert np.array_equal(got[f], ja(getattr(table, f), s, n)), f
        assert tc[s].n_unitigs == u
        for f in ("uid", "pos"):
            assert np.array_equal(getattr(tc[s], f).numpy(), ja(getattr(chains, f), s, n)), f
        assert np.array_equal(tc[s].flip.numpy(), ja(chains.flip, s, n).astype(bool))
        for f in ("length", "first_item", "last_item", "first_flip", "last_flip"):
            assert np.array_equal(getattr(tc[s], f).numpy(), ja(getattr(chains, f), s, u)), f
        assert np.array_equal(tu[s].numpy(), ja(u_exts, s, u))
        assert np.array_equal(tcb[s].numpy(), ja(contrib, s, n))
    keys = np.concatenate([table_to_numpy(t)["kmers"] for t in tt])
    assert len(np.unique(keys, axis=0)) == len(keys)


@pytest.mark.parametrize("collective", [True, False])
def test_assemble_sharded_gfa_matches_jax(reads, mesh, tmesh, tmp_path, collective):
    """Both stitches at min_obs = 2: the same GFA bytes as JAX's same form,
    and as the port's other form."""
    want = assemble_sharded(reads, K, P, min_obs=2, mesh=mesh, collective=collective,
                            cap_per_dest=CAP)
    stats = {}
    got = TP.assemble_sharded(reads, K, P, min_obs=2, mesh=tmesh, collective=collective,
                              device=CPU, stats=stats)
    assert len(got) > 1
    assert gfa_bytes(got, tmp_path / "t.gfa") == gfa_bytes(want, tmp_path / "j.gfa")
    other = TP.assemble_sharded(reads, K, P, min_obs=2, mesh=tmesh, collective=not collective,
                                device=CPU)
    assert gfa_bytes(other, tmp_path / "o.gfa") == gfa_bytes(got, tmp_path / "t.gfa")
    assert sum(stats["intervals"]) > 0 and len(stats["count_s"]) == 8
    assert ("stitch_s" in stats) == collective


def test_sharded_edge_inputs(rng, tmesh):
    """Few reads over 8 shards leave some shards empty; a closure reduce;
    refusals."""
    contig = rng.integers(0, 4, 200).astype(np.uint8)
    reads = [contig[:70], contig[40:110]]
    stats = {}
    _, tables, chains, *_ = TP.sharded_tables(reads, K, P, mesh=tmesh, device=CPU, stats=stats)
    assert 0 in stats["intervals"] and [len(t) for t in tables].count(0) >= 1
    assert all(c.n_unitigs == 0 for t, c in zip(tables, chains) if len(t) == 0)
    table = F.filter_kmers([(r, 0, 0) for r in reads], K, stranded=False, min_obs=1)
    want = G.from_compress_output(K, False, C.compress_kmers(table)).finish()
    for coll in (True, False):
        got = TP.assemble_sharded(reads, K, P, mesh=tmesh, collective=coll, device=CPU)
        assert canon_nodes(got) == canon_nodes(want)
    closure = lambda a, b: max(a, b) + 1
    g1 = TP.assemble_sharded(reads, K, P, mesh=tmesh, device=CPU, data_reduce_compress=closure)
    g2 = TP.assemble_sharded(reads, K, P, mesh=tmesh, device=CPU, data_reduce_compress=closure,
                             collective=False)
    assert list(g1.data) == list(g2.data)
    # every kmer censored: no node, and no stitch to run
    assert len(TP.assemble_sharded(reads, K, P, min_obs=9, mesh=tmesh, device=CPU)) == 0
    with pytest.raises(ValueError, match="no reads"):
        TP.sharded_tables([contig[:10]], K, P, mesh=tmesh, device=CPU)
    with pytest.raises(ValueError, match="lies on"):
        TP.sharded_tables(reads, K, P, mesh=tmesh)


def test_skewed_minimizers_equal_unsharded(rng, tmesh):
    """The equality part of test_auto_cap_skewed_minimizers: low-entropy
    reads put nearly every interval on two shards; nothing overflows here
    and the graph equals the unsharded one.  slack and cap_per_dest are
    accepted and unused."""
    k, p = 16, 15
    base = np.tile([0, 3], 40).astype(np.uint8)
    reads = []
    for _ in range(32):
        r = base.copy()
        r[int(rng.integers(0, len(r)))] = int(rng.integers(0, 4))
        reads.append(r)
    stats = {}
    got = TP.assemble_sharded(reads, k, p, mesh=tmesh, device=CPU, slack=0.05, stats=stats)
    assert sum(sorted(stats["intervals"])[-2:]) >= 0.9 * sum(stats["intervals"])
    table = F.filter_kmers([(r, 0, 0) for r in reads], k, stranded=False, min_obs=1)
    want = G.from_compress_output(k, False, C.compress_kmers(table)).finish()
    assert canon_nodes(got) == canon_nodes(want)
    again = TP.assemble_sharded(reads, k, p, mesh=tmesh, device=CPU, cap_per_dest=1)
    assert canon_nodes(again) == canon_nodes(got)


def test_permutation_balances_skewed_minimizers(rng, mesh, tmesh):
    """A poly-A-rich corpus: the inverse-frequency table cuts the max/mean
    destination load and leaves the graph identical; the histograms equal
    JAX's."""
    k, p = 31, 6
    reads = []
    for _ in range(160):
        r = rng.integers(0, 4, 90).astype(np.uint8)
        s = int(rng.integers(0, 60))
        r[s : s + 24] = 0
        reads.append(r)
    bases, lengths = F.pad_reads(reads, min_len=k, pad_to=16)
    perm = TM.inverse_frequency_score_table(p, bases, lengths)
    assert np.array_equal(perm, M.inverse_frequency_score_table(p, bases, lengths))
    hists = []
    for pm in (None, perm):
        h = TP.dest_histogram(k, p, 8, bases, lengths, permutation=pm, device=CPU)
        want = _dest_histogram_fn(k, p, 8, False, mesh, None if pm is None else jnp.asarray(pm))(
            jnp.asarray(bases), jnp.asarray(lengths))
        assert np.array_equal(h, np.asarray(want))
        hists.append(h.sum(0))
    ratio = [h.max() / max(h.mean(), 1) for h in hists]
    assert ratio[1] < ratio[0], ratio
    g_perm = TP.assemble_sharded(reads, k, p, mesh=tmesh, permutation=perm, device=CPU)
    g_plain = TP.assemble_sharded(reads, k, p, mesh=tmesh, device=CPU)
    assert canon_nodes(g_perm) == canon_nodes(g_plain)


# ---------------------------------------------------------------------------
# the graph functions, from the same JAX graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_graph(reads, labels, mesh):
    """JAX's combined shard graph before the stitch (assemble_sharded's host
    path input), with data = the max label of each shard unitig: many
    nodes to join, and data that differs between them."""
    plan, table, chains, u_exts, contrib = jax_tables(reads, labels, mesh, "max", 1)
    g = G.BaseGraph(K, False)
    nu = np.asarray(chains.n_unitigs)
    for s in range(8):
        g.add_flat(*C.assemble_unitigs_flat(
            plan.spec, np.asarray(table.kmers)[s], *(np.asarray(getattr(chains, f))[s] for f in (
                "uid", "pos", "flip", "length", "first_item", "first_flip")),
            int(nu[s]), np.asarray(u_exts)[s], np.asarray(contrib)[s], np.asarray(table.data)[s],
            data_reduce="max"))
    return g


def _pair(base):
    """The JAX graph and the port's (on the CPU) from one JAX BaseGraph."""
    jg = G.BaseGraph.combine([base]).finish()
    return jg, graph_from_reference(jg).finish(device=CPU)


def rows(graph) -> list:
    return [(graph.base.sequences.get_bases(i).tolist(), int(graph.exts[i]), int(graph.data[i]))
            for i in range(len(graph))]


COMPRESS = {
    "default": dict(),
    "censor": dict(censor_nodes=[0, 3, 7, 11]),
    "max": dict(data_reduce="max"),
    "closure": dict(data_reduce=lambda a, b: (3 * a + b) % 101),
    "join_on_data": dict(join_on_data=True, data_reduce="min"),
    "spec": dict(spec_of=lambda Cm: Cm.CompressionSpec("sum", join_labels=lambda d: d % 2)),
}


@pytest.mark.parametrize("case", sorted(COMPRESS))
def test_compress_graph_matches_jax(shard_graph, tmp_path, case):
    from tpu_debruijn_torch import compress as TC

    kw = dict(COMPRESS[case])
    spec_of = kw.pop("spec_of", None)
    jg, tg = _pair(shard_graph)
    want = G.compress_graph(jg, **kw, **({} if spec_of is None else {"spec": spec_of(C)}))
    got = TG.compress_graph(tg, **kw, **({} if spec_of is None else {"spec": spec_of(TC)}),
                            device=CPU)
    assert np.array_equal(tg.exts, jg.exts)  # the input's exts were fixed alike
    assert rows(got) == rows(want) and len(got) < len(tg)
    assert gfa_bytes(got, tmp_path / "t.gfa") == gfa_bytes(want, tmp_path / "j.gfa")


def test_compress_graph_rich_union(shard_graph):
    """The rich sidecar: sorted set unions by default, or a given fold."""
    jg, _ = _pair(shard_graph)
    rich = [tuple(sorted({int(d), i % 3})) for i, d in enumerate(jg.data)]
    base = G.BaseGraph(K, False)
    base.add_flat(jg.base.sequences._flat(), jg.base.sequences.length, jg.exts, jg.data, rich=rich)
    for fold in (None, lambda a, b: a + b):
        jg, tg = _pair(base)
        want = G.compress_graph(jg, rich_reduce=fold)
        got = TG.compress_graph(tg, rich_reduce=fold, device=CPU)
        assert got.rich == want.rich and rows(got) == rows(want)


def test_fix_exts_edges_and_nodes(shard_graph):
    """find_edges / get_valid_exts / fix_exts and Node against JAX on a graph
    whose cross-shard extensions point nowhere yet."""
    jg, tg = _pair(shard_graph)
    valid = np.arange(len(jg)) % 4 != 0
    for i in range(len(jg)):
        for d in (0, 1):
            assert tg.find_edges(i, d) == jg.find_edges(i, d)
        assert tg.get_valid_exts(i, valid) == jg.get_valid_exts(i, valid)
        assert tg.get_valid_exts(i, None) == jg.get_valid_exts(i, None)
    node, jnode = tg.get_node(5), jg.get_node(5)
    assert (node.len(), node.data(), node.exts().val) == (jnode.len(), jnode.data(), jnode.exts().val)
    assert (node.l_edges(), node.r_edges(), node.edges(1)) == (jnode.l_edges(), jnode.r_edges(),
                                                               jnode.edges(1))
    assert [n.node_id for n in tg.iter_nodes()] == list(range(len(tg)))
    jg.fix_exts(valid)
    tg.fix_exts(valid)
    assert np.array_equal(tg.exts, jg.exts) and np.array_equal(tg.base.exts, jg.base.exts)
    jg.fix_exts(None)
    tg.fix_exts(None)
    assert np.array_equal(tg.exts, jg.exts)
    assert all(tg.find_edges(i, d) == jg.find_edges(i, d) for i in range(len(jg)) for d in (0, 1))


@pytest.mark.parametrize("tip_len", [2, 4])
def test_clean_tips_matches_jax(shard_graph, tmp_path, tip_len):
    """Tips under len < tip_len * K: the same graph as JAX's, and compressed:
    compress_graph on it again changes no node row."""
    jg, tg = _pair(shard_graph)
    pred = lambda n: n.len() < tip_len * K
    assert TCL.CleanGraph(pred).find_bad_nodes(tg) == CL.CleanGraph(pred).find_bad_nodes(jg)
    assert [TCL.CleanGraph(pred).test_tip(tg, i) for i in range(len(tg))] == \
        [CL.CleanGraph(pred).test_tip(jg, i) for i in range(len(jg))]
    want = CL.clean_tips(jg, pred)
    got = TCL.clean_tips(tg, pred, device=CPU)
    assert rows(got) == rows(want)
    assert gfa_bytes(got, tmp_path / "t.gfa") == gfa_bytes(want, tmp_path / "j.gfa")
    assert rows(TG.compress_graph(got, device=CPU)) == rows(got)
