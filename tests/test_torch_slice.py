"""Port parity for the whole slice: the README quick start run through the
JAX package and through tpu_debruijn_torch (device="cpu") on one FASTQ
file must write byte-identical GFA files."""

import ast
import gzip
import pathlib
import subprocess
import sys

import numpy as np
import pytest

_LUT = np.frombuffer(b"ACGT", np.uint8)


def _write_fastq(path, genome, rng, n_reads, read_len):
    with gzip.open(path, "wt") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, len(genome) - read_len))
            r = genome[s : s + read_len]
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(f"@r{i}\n{bytes(_LUT[r]).decode()}\n+\n{'I' * read_len}\n")


def _genome(rng, repeat_rich):
    if not repeat_rich:
        return rng.integers(0, 4, 800)
    pool = [rng.integers(0, 4, 60) for _ in range(5)]
    return np.concatenate([pool[int(i)] for i in rng.integers(0, 5, 14)])


@pytest.mark.parametrize("repeat_rich", [False, True])
def test_quickstart_gfa_identical(tmp_path, rng, repeat_rich):
    path = str(tmp_path / "reads.fq.gz")
    _write_fastq(path, _genome(rng, repeat_rich), rng, 160, 80)

    from tpu_debruijn import compress as C, filter as F, io as IO
    from tpu_debruijn.graph import from_compress_output

    reads = IO.read_fastq(path)
    table = F.filter_kmers([(r, 0, 0) for r in reads], k=31, stranded=False, min_obs=2)
    graph = from_compress_output(31, False, C.compress_kmers(table)).finish()
    graph.to_gfa(str(tmp_path / "jax.gfa"))

    import tpu_debruijn_torch as T

    treads = T.read_fastq(path)
    ttable = T.filter_kmers([(r, 0, 0) for r in treads], k=31, stranded=False,
                            min_obs=2, device="cpu")
    tnodes = T.compress_kmers(ttable, device="cpu")
    tgraph = T.from_compress_output(31, False, tnodes).finish(device="cpu")
    tgraph.to_gfa(str(tmp_path / "torch.gfa"))

    want = (tmp_path / "jax.gfa").read_bytes()
    got = (tmp_path / "torch.gfa").read_bytes()
    assert got == want
    assert got.count(b"\nS\t") == len(tgraph) >= 1
    if repeat_rich:
        assert len(tgraph) > 1 and b"\nL\t" in got


def test_combined_graphs_gfa_identical(tmp_path, rng):
    from tpu_debruijn import compress as C, filter as F
    from tpu_debruijn.graph import BaseGraph, from_compress_output

    import tpu_debruijn_torch as T

    parts = []
    for _ in range(2):
        g = rng.integers(0, 4, 300)
        reads = [(g[s : s + 70].astype(np.uint8), 0, 0) for s in rng.integers(0, 230, 60)]
        table = F.filter_kmers(reads, 31, stranded=False, min_obs=2)
        parts.append(C.compress_kmers(table))
    BaseGraph.combine([from_compress_output(31, False, p) for p in parts]).finish().to_gfa(
        str(tmp_path / "jax.gfa"))
    T.BaseGraph.combine([T.from_compress_output(31, False, p) for p in parts]).finish(
        device="cpu").to_gfa(str(tmp_path / "torch.gfa"))
    assert (tmp_path / "torch.gfa").read_bytes() == (tmp_path / "jax.gfa").read_bytes()
    with pytest.raises(ValueError):
        T.BaseGraph.combine([T.BaseGraph(31, False), T.BaseGraph(31, True)])


def test_port_never_imports_jax():
    """Every module of the port imports without JAX or the JAX package, no
    shared object of the JAX package is loaded once the host codec is (the
    port builds its own), and chip_smoke.py names neither in any import."""
    code = (
        "import importlib, pkgutil, sys, tpu_debruijn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpu_debruijn_torch.__path__, 'tpu_debruijn_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'tpu_debruijn_torch.kernels.pointer_jump' in names, names\n"
        "from tpu_debruijn_torch import assemble, clean, compress, exts, filter, graph, kmer, msp, "
        "neighbors, parallel\n"
        "assert 'tpu_debruijn_torch.assemble' in names and 'tpu_debruijn_torch.neighbors' in names\n"
        "assert 'tpu_debruijn_torch.parallel.multihost' in names, names\n"
        "import tpu_debruijn_torch.parallel.multihost\n"
        "for mod, attrs in ((tpu_debruijn_torch, 'CompressionSpec SimpleCompress ScmapCompress "
        "compress_kmers_color_sets compress_kmers_rich compress_kmers_no_exts'), (compress, "
        "'assemble_unitigs_device compress_kmers_flat_device infer_exts_device'), (filter, "
        "'filter_kmers_set filter_kmers_set_arrays filter_kmers_eq_classes assign_eq_classes eq_class_ids "
        "CountFilterEqClass filter_kmers_with_summarizer remove_censored_exts_sharded'), "
        "(graph, 'from_flat_output compress_graph Node'), (parallel, 'sharded_tables "
        "assemble_sharded make_mesh ShardPlan global_mesh initialize local_read_slice "
        "assemble_multiprocess assemble_multihost LogicalMesh'), (parallel.multihost, 'initialize "
        "local_read_slice global_mesh assemble_multiprocess assemble_multihost'), (msp, 'msp_intervals_device'), (clean, 'clean_tips'), "
        "(compress, 'stitch_flat'), (graph.DebruijnGraph, 'is_empty search_kmer find_link is_compressed "
        "sequence_of_path max_path max_path_beam write_gfa to_gfa_with_tags to_dot to_json_rest to_json "
        "print print_with_data save load'), (graph.Node, 'sequence iter_kmers'), (filter.KmerTable, "
        "'kmer_ints get_key_id get get_key to_tuples save load'), (tpu_debruijn_torch, 'bases Dir Exts "
        "DnaSeq DnaSeqBuilder PackedSeqSet SeqSlice'), (neighbors, 'one_hamming_iter'), (assemble, "
        "'run main'), (kmer, 'from_int to_int from_bases to_bases to_string from_string kmers_from_bytes "
        "kmers_from_ascii empty mask_value extend min_rc set_base hamming_dist at_count gc_count "
        "hamming_neighbors'), (exts, 'merge add mk_left mk_right mk single_dir from_slice_bounds')):\n"
        "    missing = [a for a in attrs.split() if not hasattr(mod, a)]\n"
        "    assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'tpu_debruijn') or m.startswith(('jax.', 'tpu_debruijn.')))\n"
        "assert not bad, bad\n"
        "from tpu_debruijn_torch.io import native\n"
        "assert native.native_available()\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "assert any('libtdb_host_codec' in f for f in maps)\n"
        "bad = sorted({f for f in maps if '/tpu_debruijn/' in f})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    imported = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert "tpu_debruijn_torch" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "tpu_debruijn")], imported
