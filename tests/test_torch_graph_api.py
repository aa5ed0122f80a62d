"""The port's graph API and ``KmerTable`` lookups against the JAX package,
exactly: ``Node`` (its repr fixed to the reference's), ``search_kmer`` /
``find_link``, ``is_compressed`` with ``join_test``, the walks
(``max_path``, ``max_path_beam`` on the reference's multi-node,
branchy-bubble and cyclic cases, ties and long bubble chains, and
``sequence_of_path``), the GFA / dot / JSON exports and printouts, and
checkpoints of graphs and tables written by either package and read by
the other."""

import io

import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn import kmer as RK
from tpu_debruijn.oracle import ref as O
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import kmer as TK
from tpu_debruijn_torch.convert import graph_from_reference
from tpu_debruijn_torch.exts import Exts


def _pair(jax_graph):
    """The JAX graph and the port's copy of it on the CPU."""
    return jax_graph, graph_from_reference(jax_graph).finish(device="cpu")


@pytest.fixture(scope="module")
def contig_graphs():
    """Graphs of the oracle's random contigs (a third of them seen twice),
    built once a module: (k, stranded) -> (JAX graph, port graph)."""
    contigs = O.random_contigs(np.random.default_rng(1))
    out = {}
    for k, stranded in ((16, False), (16, True), (31, False)):
        seqs = [(np.array(c, np.uint8), 0, 0) for c in contigs if len(c) >= k]
        tab = F.filter_kmers(seqs + seqs[::3], k, stranded=stranded, min_obs=1)
        out[k, stranded] = _pair(G.from_compress_output(k, stranded, C.compress_kmers(tab)).finish())
    return out


def _bubble_chain(seed, length, snp_every, k=21):
    """Two strains of a random genome, a substitution every ``snp_every``
    bases, the first seen three times: a chain of bubbles whose best path
    crosses every bubble on the first strain's side."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, length).astype(np.uint8)
    b = a.copy()
    pos = np.arange(snp_every // 2, length - k, snp_every)
    b[pos] = (b[pos] + 1) % 4
    tab = F.filter_kmers([(a, 0, 0)] * 3 + [(b, 0, 0)], k, stranded=False, min_obs=1)
    return _pair(G.from_compress_output(k, False, C.compress_kmers(tab)).finish())


def _walk_cases():
    rng = np.random.default_rng(2024)
    k = 15
    # multi-node (tests/test_graph.py::test_max_path_beam_multi_node)
    genome = rng.integers(0, 4, 200)
    reads = [(genome[:80], 0, 1), (genome[60:140], 0, 2), (genome[120:], 0, 3)]
    tab = F.filter_kmers(reads, k, stranded=True, min_obs=1, data_reduce="min")
    nodes = C.compress_kmers(tab, data_reduce="first", join_on_data=True, data_field="data")
    yield "multi_node", G.from_compress_output(k, True, nodes).finish()
    # branchy bubble (test_max_path_beam_branchy_bubble)
    fa, fb, mh, ml = (rng.integers(0, 4, n) for n in (60, 60, 40, 40))
    hi = np.concatenate([fa, mh, fb]).astype(np.uint8)
    lo = np.concatenate([fa, ml, fb]).astype(np.uint8)
    tab = F.filter_kmers([(hi, 0, 0)] * 3 + [(lo, 0, 0)], k, stranded=True, min_obs=1)
    yield "branchy_bubble", G.from_compress_output(k, True, C.compress_kmers(tab)).finish()
    # cyclic, and a tail entering the cycle (test_max_path_beam_cyclic_terminates)
    core = rng.integers(0, 4, 120).astype(np.uint8)
    circular = np.concatenate([core, core[:k]])
    tab = F.filter_kmers([(circular, 0, 0)], k, stranded=True, min_obs=1)
    yield "cyclic", G.from_compress_output(k, True, C.compress_kmers(tab)).finish()
    entry = np.concatenate([rng.integers(0, 4, 50), core[:40]]).astype(np.uint8)
    tab = F.filter_kmers([(circular, 0, 0), (entry, 0, 0)], k, stranded=True, min_obs=1)
    yield "cyclic_tail", G.from_compress_output(k, True, C.compress_kmers(tab)).finish()


@pytest.fixture(scope="module")
def walk_graphs(contig_graphs):
    graphs = {name: _pair(g) for name, g in _walk_cases()}
    graphs["contigs_unstranded"] = contig_graphs[16, False]
    graphs["contigs_stranded"] = contig_graphs[16, True]
    graphs["bubble_chain"] = _bubble_chain(3, 8000, 40)
    return graphs


SCORES = {"count": lambda d: float(d), "tie": lambda d: 1.0, "parity": lambda d: float(d % 2)}


@pytest.mark.parametrize("case", ["multi_node", "branchy_bubble", "cyclic", "cyclic_tail",
                                  "contigs_unstranded", "contigs_stranded", "bubble_chain"])
@pytest.mark.parametrize("score", sorted(SCORES))
def test_walks_match_reference(walk_graphs, case, score):
    """max_path_beam (beams 1, 4, 8) and max_path (solid or not) return the
    JAX package's path, node for node, and sequence_of_path its bases; the
    "tie" score makes every state tie, so the stable sort decides."""
    g, t = walk_graphs[case]
    sc = SCORES[score]
    for beam in (1, 4, 8):
        want = g.max_path_beam(beam, sc, lambda d: True)
        got = t.max_path_beam(beam, sc, lambda d: True)
        assert got == want, (beam, got, want)
        assert np.array_equal(t.sequence_of_path(got).bases(), g.sequence_of_path(want).bases())
    for solid in (lambda d: True, lambda d: False, lambda d: d % 3 == 0):
        want = g.max_path(sc, solid)
        assert t.max_path(sc, solid) == want
        assert np.array_equal(t.sequence_of_path(want).bases(), g.sequence_of_path(want).bases())
    if case == "bubble_chain":
        assert len(g.max_path_beam(4, sc, lambda d: True)) > 300
    if case == "cyclic":
        assert [p for p, _ in t.max_path_beam(4, sc, lambda d: True)] == [0, 0]


def test_walks_on_empty_graph():
    t = TG.BaseGraph(15, False).finish(device="cpu")
    assert t.max_path(float, bool) == [] and t.max_path_beam(4, float, bool) == []
    assert len(t.sequence_of_path([])) == 0 and t.is_compressed() is None


@pytest.mark.parametrize("stranded", [False, True])
def test_node_matches_reference(contig_graphs, stranded):
    """Node.exts() is an Exts and repr(Node) is the reference's, for every
    node.  The port printed ``Exts: 0x..`` where the reference prints the
    bases of each side (``AC|G``)."""
    g, t = contig_graphs[16, stranded]
    assert len(t) > 100
    for i in range(len(g)):
        jn, tn = g.get_node(i), t.get_node(i)
        assert isinstance(tn.exts(), Exts) and tn.exts().val == jn.exts().val
        assert repr(tn) == repr(jn)
        assert tn.sequence().to_dna_string() == jn.sequence().to_dna_string()
        assert all(np.array_equal(a, b) for a, b in zip(tn.iter_kmers(), jn.iter_kmers()))
        assert (tn.l_edges(), tn.r_edges(), tn.len(), tn.data()) == (
            jn.l_edges(), jn.r_edges(), jn.len(), jn.data())
    assert "Exts: 0x" not in repr(t.get_node(0))


def test_is_empty_and_data_setter():
    base = TG.BaseGraph(16, False)
    assert base.is_empty() and base.finish(device="cpu").is_empty()
    base.add(np.zeros(20, np.uint8), 0x11, 5)
    base.add(np.ones(18, np.uint8), 0x22, 6)
    assert not base.is_empty() and not base.finish(device="cpu").is_empty()
    base.data = [7, 8]
    assert base.data.dtype == np.int32 and base.data.tolist() == [7, 8]
    assert base.finish(device="cpu").data.tolist() == [7, 8]


@pytest.mark.parametrize("k,stranded", [(16, False), (16, True), (31, False)])
def test_search_kmer_and_find_link(contig_graphs, k, stranded):
    g, t = contig_graphs[k, stranded]
    spec = RK.KmerSpec(k)
    rng = np.random.default_rng(k)
    probes = list(g.first_kmers[::3]) + list(g.last_kmers[::3])
    probes += [np.asarray(RK.rc(spec, km[None]))[0] for km in probes[::2]]
    probes += list(RK.from_bases_batch_np(spec, rng.integers(0, 4, (20, k))))
    hits = 0
    for km in probes:
        for side in (0, 1):
            assert t.search_kmer(km, side) == g.search_kmer(km, side)
            hits += g.search_kmer(km, side) is not None
            assert t.find_link(km, side) == g.find_link(km, side)
    assert hits > len(probes) // 2
    empty = TG.BaseGraph(k, stranded).finish(device="cpu")
    assert empty.search_kmer(probes[0], 0) is None and empty.find_link(probes[0], 1) is None


@pytest.mark.parametrize("k", [15, 31, 33, 63])
def test_end_kmer_index_and_search(k):
    """The graph's index, read from the packed store and sorted on the
    device, against the JAX package's host index: the same end kmers, node
    ids in the order of a stable lexsort (ties in node order), and the same
    search_kmer / find_link answers.  End kmers repeat across nodes, some
    nodes are one kmer long, and lengths cross every word offset."""
    rng = np.random.default_rng(k)
    spec = RK.KmerSpec(k)
    ends = rng.integers(0, 4, (6, k)).astype(np.uint8)
    seqs = []
    for i in range(90):
        head, tail = ends[rng.integers(0, len(ends), 2)]
        mid = rng.integers(0, 4, int(rng.integers(0, 40))).astype(np.uint8)
        seqs.append(head if i % 7 == 0 else np.concatenate([head, mid, tail]))
    base = G.BaseGraph(k, False)
    base.add_flat(np.concatenate(seqs), [len(s) for s in seqs], np.full(len(seqs), 0xFF),
                  np.arange(len(seqs)))
    g, t = _pair(base.finish())
    assert np.array_equal(t.first_kmers, g.first_kmers)
    assert np.array_equal(t.last_kmers, g.last_kmers)
    lk_sorted, lk_ids, rk_sorted, rk_ids = t._index
    for kmers, ids, srt in ((g.first_kmers, lk_ids, lk_sorted), (g.last_kmers, rk_ids, rk_sorted)):
        want = np.lexsort(tuple(kmers[:, i] for i in range(kmers.shape[1] - 1, -1, -1)))
        assert len(np.unique(kmers, axis=0)) < len(kmers)
        assert np.array_equal(ids.numpy(), want)
        assert np.array_equal(TK.to_numpy(srt), kmers[want])
    probes = list(g.first_kmers) + list(g.last_kmers)
    probes += [np.asarray(RK.rc(spec, km[None]))[0] for km in probes[::5]]
    probes += list(RK.from_bases_batch_np(spec, rng.integers(0, 4, (20, k))))
    for km in probes:
        for side in (0, 1):
            assert t.search_kmer(km, side) == g.search_kmer(km, side)
            assert t.find_link(km, side) == g.find_link(km, side)


@pytest.mark.parametrize("payloads", ["int", "mixed"])
def test_from_compress_output_matches_add_loop(payloads):
    """from_compress_output's one add_flat gives what a BaseGraph.add a
    node gives: sequences, exts, data, and the rich sidecar (None for an
    int node, only once any node is rich)."""
    rng = np.random.default_rng(5)
    nodes = []
    for i in range(60):
        seq = rng.integers(0, 4, int(rng.integers(16, 70))).astype(np.uint8)
        data = [int(rng.integers(0, 1000)), np.int32(i), np.int64(7 * i)][i % 3]
        if payloads == "mixed" and i % 4 in (1, 2):
            data = (i, i + 3) if i % 4 == 1 else {"strain": i}
        nodes.append((seq, int(rng.integers(0, 256)), data))
    got = TG.from_compress_output(16, False, nodes)
    want = TG.BaseGraph(16, False)
    for seq, exts, data in nodes:
        if isinstance(data, (int, np.integer)):
            want.add(seq, exts, int(data))
        else:
            want.add(seq, exts, 0, rich=data)
    assert len(got) == len(want) == len(nodes)
    assert np.array_equal(got.sequences._flat(), want.sequences._flat())
    assert np.array_equal(got.sequences.length, want.sequences.length)
    assert got.exts.dtype == got.data.dtype == np.int32
    assert np.array_equal(got.exts, want.exts) and np.array_equal(got.data, want.data)
    assert got.rich == want.rich and (got.rich is None) == (payloads == "int")
    empty = TG.from_compress_output(16, False, [])
    assert len(empty) == 0 and empty.rich is None and len(empty.finish(device="cpu")) == 0


def _kmer_graph(tab, k, stranded, pal=False):
    """A graph of one node a table kmer (tests/test_graph.py:51's form),
    exts and counts from the table."""
    g = G.BaseGraph(k, stranded)
    for i in range(len(tab)):
        g.add(RK.to_bases(RK.KmerSpec(k), tab.kmers[i]), int(tab.exts[i]), int(tab.counts[i]))
    return _pair(g.finish())


@pytest.mark.parametrize("k,stranded", [(16, False), (31, False), (16, True)])
def test_is_compressed_with_join_test(contig_graphs, k, stranded):
    rng = np.random.default_rng(40 + k)
    contigs = O.simple_random_contigs(rng)
    seqs = [(np.array(c, np.uint8), 0, 0) for c in contigs]
    if k == 16 and not stranded:
        # a contig through a palindromic 16-mer: K-length palindromic nodes never merge
        half = rng.integers(0, 4, 8).astype(np.uint8)
        pal = np.concatenate([half, (3 - half[::-1]).astype(np.uint8)])
        seqs.append((np.concatenate([rng.integers(0, 4, 30), pal, rng.integers(0, 4, 30)])
                     .astype(np.uint8), 0, 0))
    tab = F.filter_kmers(seqs + seqs[:2], k, stranded=stranded, min_obs=1)
    g, t = _kmer_graph(tab, k, stranded)
    assert g.is_compressed() is not None
    for jt in (None, lambda a, b: a == b, lambda a, b: False, lambda a, b: (a + 2 * b) % 3 == 0):
        assert t.is_compressed(jt) == g.is_compressed(jt)
    # a compressed graph has no pair left
    gc, tc = contig_graphs[k, stranded]
    assert tc.is_compressed() is None and gc.is_compressed() is None


def test_is_compressed_dangling_extension():
    """With min_obs = 2 a read's substitution leaves a node side with two
    extensions, one onto a kmer the count dropped: compress_kmers does not
    join there, and is_compressed, which counts only extensions that reach
    a node, returns that pair, the same in both packages; compress_graph,
    which drops the dangling extension first, leaves no pair."""
    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    bad = genome.copy()
    bad[200] ^= 1
    tab = F.filter_kmers([(genome, 0, 0), (genome, 0, 0), (bad, 0, 0)], 21, min_obs=2)
    g, t = _pair(G.from_compress_output(21, False, C.compress_kmers(tab)).finish())
    assert len(t) == 3 and t.is_compressed() == g.is_compressed() is not None
    assert TG.compress_graph(t, device="cpu").is_compressed() is None


@pytest.mark.parametrize("k,stranded", [(16, False), (16, True), (31, False), (0, False)])
def test_exports_and_prints(contig_graphs, k, stranded, tmp_path, capsys):
    """write_gfa == to_gfa == the JAX package's bytes; tagged GFA, dot,
    JSON (with and without ``rest``) and both printouts the same bytes;
    k = 0 stands for an empty graph at K = 16."""
    if k == 0:
        g, t = _pair(G.BaseGraph(16, stranded).finish())
    else:
        g, t = contig_graphs[k, stranded]
    files = {}
    for name, gr in (("jax", g), ("torch", t)):
        w = io.StringIO()
        gr.write_gfa(w)
        gr.to_gfa(tmp_path / f"{name}.gfa")
        gr.to_gfa_with_tags(tmp_path / f"{name}.tags.gfa", lambda n: f"RC:i:{n.data()}\tLN:i:{n.len()}")
        gr.to_dot(tmp_path / f"{name}.dot", lambda d: f"c{d}")
        js, rest = io.StringIO(), io.StringIO()
        gr.to_json(lambda d: d, js)
        gr.to_json_rest(lambda d: {"count": d, "odd": d % 2 == 1}, rest, {"k": k, "tags": [1, "x"]})
        capsys.readouterr()
        gr.print()
        gr.print_with_data()
        files[name] = (w.getvalue(), (tmp_path / f"{name}.gfa").read_bytes(),
                       (tmp_path / f"{name}.tags.gfa").read_bytes(),
                       (tmp_path / f"{name}.dot").read_bytes(), js.getvalue(), rest.getvalue(),
                       capsys.readouterr().out)
    assert files["torch"] == files["jax"]
    assert files["torch"][0].encode() == files["torch"][1]


def _same_npz(a, b) -> bool:
    za, zb = np.load(a), np.load(b)
    return sorted(za.files) == sorted(zb.files) and all(
        za[f].dtype == zb[f].dtype and np.array_equal(za[f], zb[f]) for f in za.files)


def _gfa(graph, path) -> bytes:
    graph.to_gfa(path)
    return open(path, "rb").read()


RICH = {
    "none": None,
    "int_seqs": lambda i: None if i % 5 == 0 else tuple(range(i % 4)) + (np.int64(-3), 2**40),
    "pickled": lambda i: ("strain", i, {"pos": [i, i + 1]}) if i % 3 else None,
}


@pytest.mark.parametrize("rich", sorted(RICH))
def test_graph_checkpoints_cross_load(contig_graphs, rich, tmp_path):
    """A graph saved by either package loads in the other to the same nodes,
    data, exts, sidecar and GFA bytes, and both write the same npz arrays."""
    g, _ = contig_graphs[16, False]
    if RICH[rich] is not None:
        seqs = g.base.sequences
        base = G.BaseGraph(16, False)
        base.add_flat(seqs._flat(), seqs.length, g.exts, g.data,
                      rich=[RICH[rich](i) for i in range(len(g))])
        g = base.finish()
    t = graph_from_reference(g).finish(device="cpu")
    g.save(tmp_path / "jax.npz")
    t.save(tmp_path / "torch.npz")
    assert _same_npz(tmp_path / "jax.npz", tmp_path / "torch.npz")
    want_gfa = _gfa(g, tmp_path / "want.gfa")
    from_jax = TG.DebruijnGraph.load(tmp_path / "jax.npz", device="cpu")
    from_torch = G.DebruijnGraph.load(tmp_path / "torch.npz")
    for got in (from_jax, from_torch):
        assert _gfa(got, tmp_path / "got.gfa") == want_gfa
        assert got.data.tolist() == g.data.tolist() and got.exts.tolist() == g.exts.tolist()
    want_rich = G.DebruijnGraph.load(tmp_path / "jax.npz").rich
    assert from_jax.rich == want_rich and from_torch.rich == want_rich
    if rich == "int_seqs":
        assert "rich_flat" in np.load(tmp_path / "torch.npz").files
    if rich == "pickled":
        assert "rich_pickle" in np.load(tmp_path / "torch.npz").files


def test_graph_checkpoint_legacy_bases(contig_graphs, tmp_path):
    """An unpacked ``bases`` checkpoint (the legacy form) loads in both."""
    g, _ = contig_graphs[16, True]
    seqs = g.base.sequences
    np.savez_compressed(tmp_path / "legacy.npz", k=16, stranded=True, lengths=seqs.length,
                        bases=seqs._flat(), exts=g.exts, data=g.data,
                        rich_flat=np.arange(len(g), dtype=np.int64),
                        rich_split=np.arange(len(g) + 1, dtype=np.int64))
    want = G.DebruijnGraph.load(tmp_path / "legacy.npz")
    got = TG.DebruijnGraph.load(tmp_path / "legacy.npz", device="cpu")
    assert _gfa(got, tmp_path / "a.gfa") == _gfa(want, tmp_path / "b.gfa")
    assert got.rich == want.rich and got.stranded and got.spec.k == 16


@pytest.mark.parametrize("k,report_all", [(16, True), (31, False), (63, True)])
def test_kmer_table_lookups_and_checkpoints(k, report_all, tmp_path):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    reads = [(genome[s : s + 90].copy(), 0, i) for i, s in enumerate(rng.integers(0, 510, 40))]
    reads[3] = ((3 - reads[3][0][::-1]).astype(np.uint8), 0, 3)
    want = F.filter_kmers(reads, k, min_obs=2, report_all=report_all)
    got = TF.filter_kmers(reads, k, min_obs=2, report_all=report_all, device="cpu")
    assert len(got) == len(want) > 50
    assert got.kmer_ints() == want.kmer_ints()
    assert got.to_tuples() == want.to_tuples()
    spec = RK.KmerSpec(k)
    absent = RK.from_bases_batch_np(spec, rng.integers(0, 4, (30, k)))
    for km in list(want.kmers[::7]) + list(absent) + [want.kmers[0], want.kmers[-1]]:
        assert got.get_key_id(km) == want.get_key_id(km)
        assert got.get(km) == want.get(km)
    for i in (0, len(want) // 2, len(want) - 1):
        assert got.get_key(i).dtype == np.uint32 and np.array_equal(got.get_key(i), want.get_key(i))
    want.save(tmp_path / "jax.npz")
    got.save(tmp_path / "torch.npz")
    assert _same_npz(tmp_path / "jax.npz", tmp_path / "torch.npz")
    from_jax = TF.KmerTable.load(tmp_path / "jax.npz", device="cpu")
    from_torch = F.KmerTable.load(tmp_path / "torch.npz")
    for name in ("kmers", "exts", "counts", "data", "all_kmers"):
        a, b = getattr(got, name), getattr(from_jax, name)
        assert (a is None and b is None) or torch.equal(a, b), name
        c, d = getattr(want, name), getattr(from_torch, name)
        assert (c is None and d is None) or (c.dtype == d.dtype and np.array_equal(c, d)), name
    assert (from_jax.spec, from_jax.stranded) == (got.spec, got.stranded)
    empty = TF.filter_kmers([], k, device="cpu")
    assert empty.get_key_id(absent[0]) is None and empty.get(absent[0]) is None
    assert empty.kmer_ints() == [] and TK.to_numpy(empty.kmers).shape == (0, spec.w)
