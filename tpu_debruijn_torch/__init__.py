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

and the colored path and the policy layer,

    filter.filter_kmers_set_arrays -> compress_kmers_color_sets
        -> graph.from_flat_output / from_compress_output
    filter.filter_kmers_set / filter_kmers_eq_classes /
        filter_kmers_with_summarizer (KmerSummarizer, CountFilter*)
    compress_kmers(spec=CompressionSpec / SimpleCompress / ScmapCompress,
                   data_reduce=, join_on_data=, data_field=),
    compress_kmers_rich, compress_kmers_no_exts,
    filter.remove_censored_exts(_sharded)

with the modules they run: ``bases``, ``io`` (FASTA/FASTQ reading, whole
or in packed blocks, with the port's own host codec), ``kmer``, ``exts``,
``sorting``, ``filter`` (``data_reduce`` 'label_first', 'min', 'max',
'sum', 'obs_min' and 'none'; the host and device merges of streaming and
its colored pairs; label sets, eq classes, summarizers, censored
extensions), ``compress`` (every policy; ``link_chains`` and
``link_chains_ordered``; unitig assembly on the host or on the device),
``dna`` (``PackedSeqSet``), ``graph`` (``BaseGraph`` with its ``rich``
sidecar, link table, ``Node``, ``fix_exts``, ``compress_graph``, GFA
export), ``msp`` (the minimizer scan and its host API), ``parallel``
(``make_mesh``, ``ShardPlan``, ``sharded_tables``, ``assemble_sharded``),
``clean`` (tips), ``convert`` (tables and graphs) and the kernels in
``kernels/``: the two kmer kernels, the gathers and pointer jumps that
replace the Pallas gather probes, among them the doubling loop of chain
linking in one launch, and the ruling-set list ranking.

Not ported yet: ``KmerTable``'s ``get``/``get_key_id``/``to_tuples``/
``save``/``load``, the batched ``read_fastx``, ``parallel.multihost``
(several processes), the rest of ``graph`` (``is_compressed``, walks,
dot/JSON export, save/load with the ``rich`` sidecar, ``Node.sequence``),
``neighbors`` and ``dna``'s ``DnaSeq``, and the ``dna``/``kmer``/``exts``
helpers the paths above do not run.
"""

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
from tpu_debruijn_torch.filter import KmerTable, PackedReadBlock, filter_kmers, filter_kmers_streaming
from tpu_debruijn_torch.graph import BaseGraph, DebruijnGraph, Node, compress_graph, from_compress_output
from tpu_debruijn_torch.io import read_fasta, read_fastq, read_fastx, stream_fastx_blocks
from tpu_debruijn_torch.kmer import KmerSpec

__all__ = [
    "BaseGraph",
    "CompressionSpec",
    "DebruijnGraph",
    "KmerSpec",
    "KmerTable",
    "Node",
    "PackedReadBlock",
    "ScmapCompress",
    "SimpleCompress",
    "compress_graph",
    "compress_kmers",
    "compress_kmers_color_sets",
    "compress_kmers_no_exts",
    "compress_kmers_rich",
    "filter_kmers",
    "filter_kmers_streaming",
    "from_compress_output",
    "graph_from_reference",
    "read_fasta",
    "read_fastq",
    "read_fastx",
    "stream_fastx_blocks",
    "table_from_reference",
    "table_to_numpy",
]
