"""Port parity on reads with sequencing errors: the error-handling path
(filter_kmers at min_obs -> remove_censored_exts -> compress_kmers ->
from_compress_output -> finish -> clean_tips) against the JAX package, as
GFA bytes, and the port's own invariants on the same reads: the four
compressed graphs of chip_smoke.py's phase 12 agree as canonical sequence
sets, clean_tips removes only tips and leaves a compressed graph, the
streamed table equals the one-batch table, and the table equals a plain
numpy count.

The reads come from :func:`error_reads`, a per-read twin of
``chip_smoke.sample_error_reads``: the same draws from the same seed,
applied one read and one base at a time (test_twin_draws_the_same_reads
holds the two together).  150 bp reads at 30x of a random genome;
substitutions rising along the read from 0.1% to 0.9%, one-base insertions
and deletions at 0.01% a base.  The JAX runs are memoized at module scope:
each table shape compiles its own programs."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import clean as CL
from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn import graph as G
from tpu_debruijn_torch import clean as TCL
from tpu_debruijn_torch import compress as TC
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import graph as TG
from tpu_debruijn_torch import parallel as TP
from tpu_debruijn_torch import sorting as TS
from tpu_debruijn_torch import stream_fastx_blocks, table_to_numpy

import chip_smoke

CPU = "cpu"
READ_LEN, COVERAGE = 150, 30
SMALL, LARGE = 3_000, 10_000  # genome lengths: the JAX cases, the port's own checks
P, SHARDS = 8, 8


def error_reads(rng, genome: np.ndarray, coverage: int = COVERAGE, read_len: int = READ_LEN):
    """The reads of chip_smoke.sample_error_reads, one read and one base at
    a time: each window base kept unless deleted, followed by its inserted
    base if any, cut to ``read_len``; the strand flip; each base then
    substituted where its draw falls under the rate of its position."""
    win = chip_smoke.ERR_WINDOW
    n = -(-coverage * len(genome) // read_len)
    starts = rng.integers(0, len(genome) - win + 1, n)
    dele = rng.random((n, win), dtype=np.float32) < chip_smoke.INDEL_RATE
    ins = rng.random((n, win), dtype=np.float32) < chip_smoke.INDEL_RATE
    ins_base = rng.integers(0, 4, (n, win), dtype=np.uint8)
    cut = []
    for i in range(n):
        seq = []
        for j in range(win):
            if not dele[i, j]:
                seq.append(int(genome[starts[i] + j]))
            if ins[i, j]:
                seq.append(int(ins_base[i, j]))
        cut.append(seq[:read_len])
    flip = rng.random(n) < 0.5
    draw = rng.random((n, read_len), dtype=np.float32)
    shift = rng.integers(1, 4, (n, read_len), dtype=np.uint8)
    rate = np.linspace(*chip_smoke.SUB_RATE, read_len, dtype=np.float32)
    out = np.empty((n, read_len), np.uint8)
    for i, seq in enumerate(cut):
        if flip[i]:
            seq = [3 - b for b in reversed(seq)]
        out[i] = [(b + int(shift[i, j])) % 4 if draw[i, j] < rate[j] else b
                  for j, b in enumerate(seq)]
    return out


def genome_and_reads(seed: int, length: int):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, length, dtype=np.uint8)
    return genome, error_reads(rng, genome)


def items(reads):
    return [(r, 0, 0) for r in reads]


@pytest.mark.parametrize("seed,length", [(1, SMALL), (2, LARGE)])
def test_twin_draws_the_same_reads(seed, length):
    """chip_smoke's vectorized error model and its per-read twin give the
    same reads from the same seed; the reads carry every kind of error."""
    genome, want = genome_and_reads(seed, length)
    rng = np.random.default_rng(seed)
    got, errors = chip_smoke.sample_error_reads(rng, rng.integers(0, 4, length, dtype=np.uint8),
                                                COVERAGE, READ_LEN)
    assert np.array_equal(got, want)
    assert got.shape == (-(-COVERAGE * length // READ_LEN), READ_LEN)
    assert errors["substitutions"] > 0 and errors["reads_without_error"] < len(got)
    if length == LARGE:
        assert errors["insertions"] > 0 and errors["deletions"] > 0


# ---------------------------------------------------------------------------
# the JAX package against the port, as GFA bytes
# ---------------------------------------------------------------------------

# (k, min_obs, stranded, censor): 3 K unstranded and K = 31 stranded, at both
# min_obs; remove_censored_exts at min_obs = 2, where it censors, and once at 1
CASES = [(21, 1, False, False), (21, 2, False, True), (31, 1, False, True), (31, 2, False, True),
         (33, 1, False, False), (33, 2, False, True), (31, 1, True, False), (31, 2, True, True)]
_JAX = {}


@partial(jax.jit, static_argnums=(0, 1))
def _jax_censor(spec, stranded, kmers, exts):
    """The JAX package's remove_censored_exts as one compiled program (its
    host API runs the device function op by op)."""
    return F.remove_censored_exts_device(spec, stranded, kmers, exts, jnp.int32(kmers.shape[0]))


def gfa_bytes(graph, path) -> bytes:
    graph.to_gfa(str(path))
    return path.read_bytes()


def jax_case(case, tmp_path):
    k, min_obs, stranded, censor = case
    _, reads = genome_and_reads(k + 10 * min_obs + stranded, SMALL)
    table = F.filter_kmers(items(reads), k, stranded=stranded, min_obs=min_obs)
    if censor:
        table.exts = np.asarray(_jax_censor(table.spec, stranded, jnp.asarray(table.kmers),
                                            jnp.asarray(table.exts)))
    graph = G.from_compress_output(k, stranded, C.compress_kmers(table)).finish()
    path = tmp_path / "jax_{}_{}_{}_{}.gfa".format(*case)
    out = {"graph": gfa_bytes(graph, path)}
    out["clean_tips"] = gfa_bytes(CL.clean_tips(graph, chip_smoke.tip_predicate(k)), path)
    return reads, out


def jax_gfas(case, tmp_path):
    """The reads of one case and the JAX package's GFA bytes, computed once:
    the graph of the (censored) table and its clean_tips."""
    if not _JAX:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(4) as pool:
            _JAX.update(zip(CASES, pool.map(lambda c: jax_case(c, tmp_path), CASES)))
    return _JAX[case]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "k{}-min_obs{}-{}{}".format(
    c[0], c[1], "stranded" if c[2] else "unstranded", "-censor" if c[3] else ""))
def test_error_path_gfa_matches_jax(case, tmp_path):
    """filter_kmers -> [remove_censored_exts] -> compress_kmers -> graph,
    and clean_tips(len < 2K) of it: the port's GFA bytes equal the JAX
    package's on the same error reads."""
    k, min_obs, stranded, censor = case
    reads, want = jax_gfas(case, tmp_path)
    table = TF.filter_kmers(items(reads), k, stranded=stranded, min_obs=min_obs, device=CPU)
    if censor:
        before = table.exts.clone()
        TF.remove_censored_exts(table, device=CPU)
        assert min_obs == 1 or not torch.equal(before, table.exts)  # something was censored
    graph = TG.from_compress_output(k, stranded, TC.compress_kmers(table, device=CPU)).finish(
        device=CPU)
    got = {"graph": gfa_bytes(graph, tmp_path / "port.gfa")}
    got["clean_tips"] = gfa_bytes(TCL.clean_tips(graph, chip_smoke.tip_predicate(k), device=CPU),
                                  tmp_path / "port.gfa")
    assert got == want
    # the case has tips, and clean_tips removed some
    assert got["clean_tips"].count(b"\nS\t") < got["graph"].count(b"\nS\t")


# ---------------------------------------------------------------------------
# the port alone, on a larger genome
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def large():
    return genome_and_reads(5, LARGE)


@pytest.mark.parametrize("min_obs", [1, 2])
def test_compressed_graphs_agree(large, min_obs):
    """Phase 12's checks 3 and 4: every table kmer lies in exactly one
    unitig with and without remove_censored_exts; compress_graph of the
    one-batch graph, the graph after remove_censored_exts, assemble_sharded
    and compress_graph of assemble_sharded are compressed and equal as
    canonical sequence sets."""
    _, reads = large
    k = 31
    table = TF.filter_kmers(items(reads), k, min_obs=min_obs, device=CPU)
    censored = TF.KmerTable(table.spec, False, table.kmers, table.exts.clone(), table.counts,
                            table.data)
    TF.remove_censored_exts(censored, device=CPU)
    graphs = {}
    for name, t in (("one-batch", table), ("censored", censored)):
        nodes = TC.compress_kmers(t, device=CPU)
        ukm = chip_smoke.unitig_kmers(t.spec, nodes, CPU)
        assert ukm.shape[0] == len(t) and (ukm[TS.lex_argsort(ukm)] == t.kmers).all()
        graphs[name] = TG.from_compress_output(k, False, nodes).finish(device=CPU)
    sharded = TP.assemble_sharded(reads, k, P, min_obs=min_obs,
                                  mesh=TP.make_mesh(SHARDS, device=CPU), device=CPU)
    four = {"compress_graph": TG.compress_graph(graphs["one-batch"], device=CPU),
            "censored": graphs["censored"], "assemble_sharded": sharded}
    sets = {name: chip_smoke.graph_canon(g) for name, g in four.items()}
    pairs = {name: g.is_compressed() for name, g in four.items()}
    again = TG.compress_graph(sharded, device=CPU)
    sets["compress_graph of assemble_sharded"] = chip_smoke.graph_canon(again)
    pairs["compress_graph of assemble_sharded"] = again.is_compressed()
    assert pairs == dict.fromkeys(pairs)
    assert all(s == sets["censored"] for s in sets.values())
    assert sets["censored"] == chip_smoke.canon_seqs(TC.compress_kmers(censored, device=CPU))
    if min_obs == 2:  # censoring merged nodes that the plain graph keeps apart
        assert len(graphs["one-batch"]) > len(graphs["censored"])


@pytest.mark.parametrize("min_obs", [1, 2])
def test_clean_tips_on_errors(large, min_obs, tmp_path):
    """Phase 12's check 5: each node find_bad_nodes returns passes test_tip
    and is shorter than 2K; the cleaned graph is compressed, smaller, one S
    line a node, and the same set of sequences from the sharded graph."""
    _, reads = large
    k = 31
    pred = chip_smoke.tip_predicate(k)
    table = TF.filter_kmers(items(reads), k, min_obs=min_obs, device=CPU)
    TF.remove_censored_exts(table, device=CPU)
    graph = TG.from_compress_output(k, False, TC.compress_kmers(table, device=CPU)).finish(
        device=CPU)
    bad = TCL.CleanGraph(pred).find_bad_nodes(graph)
    lens = np.asarray(graph.base.sequences.length)
    assert bad and all(TCL.CleanGraph(pred).test_tip(graph, i) == i for i in bad)
    assert (lens[bad] < 2 * k).all()
    n_in = len(graph)
    cleaned = TCL.clean_tips(graph, pred, device=CPU)
    assert cleaned.is_compressed() is None and len(cleaned) < n_in
    assert gfa_bytes(cleaned, tmp_path / "c.gfa").count(b"\nS\t") == len(cleaned)
    sharded = TP.assemble_sharded(reads, k, P, min_obs=min_obs,
                                  mesh=TP.make_mesh(SHARDS, device=CPU), device=CPU)
    assert chip_smoke.graph_canon(TCL.clean_tips(sharded, pred, device=CPU)) == \
        chip_smoke.graph_canon(cleaned)


@pytest.mark.parametrize("min_obs", [1, 2])
def test_streamed_table_equals_one_batch(large, min_obs, tmp_path):
    """Phase 12's check 2 on the CPU: the FASTQ file through
    stream_fastx_blocks and the device merge in 7 chunks, and the shard
    tables' union, against the one-batch table."""
    _, reads = large
    k = 31
    fq = str(tmp_path / "reads.fq")
    chip_smoke.write_fastq(fq, reads)
    want = table_to_numpy(TF.filter_kmers(items(reads), k, min_obs=min_obs, device=CPU))
    chunk = -(-len(reads) // 7)
    streamed = TF.filter_kmers_streaming(stream_fastx_blocks(fq, block_reads=chunk), k,
                                         min_obs=min_obs, data_reduce="none", merge="device",
                                         chunk_reads=chunk, device=CPU)
    got = table_to_numpy(streamed)
    assert all(np.array_equal(got[x], want[x]) for x in ("kmers", "exts", "counts", "data"))
    _, tables, *_ = TP.sharded_tables(reads, k, P, min_obs=min_obs,
                                      mesh=TP.make_mesh(SHARDS, device=CPU), device=CPU)
    differ = chip_smoke.check_shard_tables("errors", tables, want)
    assert differ == 0 or min_obs > 1


@pytest.mark.parametrize("min_obs", [1, 2])
@pytest.mark.parametrize("k", [21, 31])
def test_table_matches_plain_count(large, k, min_obs):
    """Phase 12's check 1: the table's kmers and counts equal a plain numpy
    count of canonical kmer codes; the genome's kmers are nearly all in it."""
    genome, reads = large
    table = TF.filter_kmers(items(reads), k, min_obs=min_obs, device=CPU)
    codes, counts = chip_smoke.plain_count(reads, k)
    keep = counts >= min_obs
    assert np.array_equal(chip_smoke.kmer_codes_of(table.kmers, k), codes[keep])
    assert np.array_equal(table.counts.numpy(), np.minimum(counts[keep], 65535))
    assert (counts == 1).sum() > len(codes) // 2  # mostly error kmers
    in_table = np.isin(chip_smoke.plain_count(genome[None, :], k)[0], codes[keep])
    assert in_table.mean() > 0.99


def test_canon_set_matches_per_unitig_form(large):
    """canon_set (whole-buffer slices, packed or at given starts) against
    each unitig's own reverse complement."""
    _, reads = large
    nodes = TC.compress_kmers(TF.filter_kmers(items(reads[:500]), 21, device=CPU), device=CPU)
    want = sorted(min(s.tobytes(), (3 - s[::-1]).astype(np.uint8).tobytes()) for s, _, _ in nodes)
    flat, lens = chip_smoke.flat_of(nodes)[:2]
    assert chip_smoke.canon_set(flat, lens) == want
    order = np.random.default_rng(0).permutation(len(lens))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    assert chip_smoke.canon_set(flat, lens[order], starts[order]) == want
