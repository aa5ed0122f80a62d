"""tpu_debruijn_torch: the PyTorch + CUDA port of tpu_debruijn.

The JAX package ``tpu_debruijn`` is the reference; this package holds the
same semantics in PyTorch, with the JAX package's Pallas kernels rewritten
as CUDA C++ for Hopper (``csrc/``, built by ``nvcc`` at first use).  It
never imports JAX.  Every public entry point takes ``device=`` (default
``"cuda"``); a kernel runs its plain PyTorch version only for a tensor on
the CPU.

Ported: the README quick start,

    read_fastq -> filter_kmers -> compress_kmers
               -> from_compress_output(...).finish() -> to_gfa

the corpus path (reads counted in chunks and merged into one table),

    stream_fastx_blocks -> filter_kmers_streaming(merge="device")
    per-read tuples or 2-D blocks -> filter_kmers_streaming(merge="host")

the read-ordered chain linking,

    filter_kmers(data_reduce="obs_min")
        -> compress.compress_kmer_table_device(first_pos=table.data)
        -> compress.assemble_chains

the MSP-sharded assembly on logical shards of one device,

    parallel.assemble_sharded(reads, k, p, mesh=parallel.make_mesh(8))
        (msp.msp_intervals_device -> exchange -> per-shard count and
         compress -> device stitch, or graph.compress_graph on the host)
    clean.clean_tips -> graph.compress_graph

the same over several processes, one device each (``torch.distributed``:
NCCL between cards, gloo on the CPU or for processes sharing a card),

    parallel.initialize(addr, n, rank) -> parallel.global_mesh(8, device)
        -> parallel.assemble_multiprocess(my_reads, k, p) or
           parallel.assemble_multihost(paths, k, p)
        (the exchange an all_to_all_single, the stitch's gathers all_gathers;
         every process returns the same graph)

the colored path and the policy layer,

    filter.filter_kmers_set_arrays -> compress_kmers_color_sets
        -> graph.from_flat_output / from_compress_output
    filter.filter_kmers_set / filter_kmers_eq_classes /
        filter_kmers_with_summarizer (KmerSummarizer, CountFilter*)
    compress_kmers(spec=CompressionSpec / SimpleCompress / ScmapCompress,
                   data_reduce=, join_on_data=, data_field=),
    compress_kmers_rich, compress_kmers_no_exts,
    filter.remove_censored_exts(_sharded)

the graph API on the assembled graph,

    DebruijnGraph.max_path / max_path_beam -> sequence_of_path -> DnaSeq
    search_kmer / find_link / find_edges / is_compressed / Node
    to_gfa / write_gfa / to_gfa_with_tags / to_dot / to_json(_rest)
    DebruijnGraph.save / load and KmerTable.save / load (the JAX
        package's npz files, readable by either package)
    KmerTable.get_key_id / get / get_key / to_tuples / kmer_ints

and the command line, ``python -m tpu_debruijn_torch.assemble reads.fq -o
out.gfa`` (``assemble.run`` in process), with the modules they run:
``bases``, ``io`` (FASTA/FASTQ reading, whole or in packed blocks, with the
port's own host codec), ``kmer`` (the limb ops, the host converters and
the bit helpers: popcounts, Hamming neighbours), ``exts`` (the tensor ops,
``Dir`` and the scalar ``Exts``), ``neighbors``, ``sorting``, ``filter``
(``data_reduce`` 'label_first', 'min', 'max', 'sum', 'obs_min' and 'none';
the host and device merges of streaming and its colored pairs; label sets,
eq classes, summarizers, censored extensions; ``KmerTable``'s lookups and
checkpoints), ``compress`` (every policy; ``link_chains`` and
``link_chains_ordered``; unitig assembly on the host or on the device),
``dna`` (``DnaSeq``, ``DnaSeqBuilder``, ``SeqSlice``, ``PackedSeqSet``),
``graph``, ``msp`` (the minimizer scan and its host API), ``parallel``
(``make_mesh``, ``ShardPlan``, ``sharded_tables``, ``assemble_sharded``;
``multihost``: ``initialize``, ``local_read_slice``, ``global_mesh``,
``assemble_multiprocess``, ``assemble_multihost``),
``clean`` (tips), ``convert`` (tables and graphs), ``assemble`` and the
kernels in ``kernels/``: the two kmer kernels, the gathers and pointer
jumps that replace the Pallas gather probes, among them the doubling loop
of chain linking in one launch, the ruling-set list ranking, and the two
sequential scans of the JAX package, each one pass over what its stage
holds: the count's whole tail over its sorted rows (``run_reduce_rows``;
``run_reduce`` for columns with known run ends) and the MSP scanner from
the read bases (``msp_scan_reads``; ``msp_scan`` over scores).

The JAX package's static-shape machinery has no counterpart by design:
see ROADMAP.md section 1 for each such name and where the port does its
work.
"""

from tpu_debruijn_torch import bases
from tpu_debruijn_torch.bases import (
    base_to_bits,
    bits_to_ascii,
    bits_to_base,
    complement,
    dna_only_base_to_bits,
    is_valid_base,
)
from tpu_debruijn_torch.compress import (
    CompressionSpec,
    ScmapCompress,
    SimpleCompress,
    compress_kmers,
    compress_kmers_color_sets,
    compress_kmers_no_exts,
    compress_kmers_rich,
)
from tpu_debruijn_torch.convert import graph_from_reference, table_from_reference, table_to_numpy
from tpu_debruijn_torch.dna import DnaSeq, DnaSeqBuilder, PackedSeqSet, SeqSlice
from tpu_debruijn_torch.exts import Dir, Exts
from tpu_debruijn_torch.filter import KmerTable, PackedReadBlock, filter_kmers, filter_kmers_streaming
from tpu_debruijn_torch.graph import BaseGraph, DebruijnGraph, Node, compress_graph, from_compress_output
from tpu_debruijn_torch.io import read_fasta, read_fastq, read_fastx, stream_fastx_blocks
from tpu_debruijn_torch.kmer import KmerSpec

__all__ = [
    "BaseGraph",
    "CompressionSpec",
    "DebruijnGraph",
    "Dir",
    "DnaSeq",
    "DnaSeqBuilder",
    "Exts",
    "KmerSpec",
    "KmerTable",
    "Node",
    "PackedReadBlock",
    "PackedSeqSet",
    "ScmapCompress",
    "SeqSlice",
    "SimpleCompress",
    "base_to_bits",
    "bases",
    "bits_to_ascii",
    "bits_to_base",
    "complement",
    "compress_graph",
    "compress_kmers",
    "compress_kmers_color_sets",
    "compress_kmers_no_exts",
    "compress_kmers_rich",
    "dna_only_base_to_bits",
    "filter_kmers",
    "filter_kmers_streaming",
    "from_compress_output",
    "is_valid_base",
    "graph_from_reference",
    "read_fasta",
    "read_fastq",
    "read_fastx",
    "stream_fastx_blocks",
    "table_from_reference",
    "table_to_numpy",
]
