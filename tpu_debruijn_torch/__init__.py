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

and the read-ordered chain linking,

    filter_kmers(data_reduce="obs_min")
        -> compress.compress_kmer_table_device(first_pos=table.data)
        -> compress.assemble_chains

with the modules they run: ``bases``, ``io`` (FASTA/FASTQ reading, whole
or in packed blocks, with the port's own host codec), ``kmer``, ``exts``,
``sorting``, ``filter`` (``data_reduce`` 'label_first', 'min', 'max',
'sum', 'obs_min' and 'none'; the host and device merges of streaming and
its colored pairs), ``compress`` (default policy; ``link_chains`` and
``link_chains_ordered``), ``dna`` (``PackedSeqSet``), ``graph``
(``BaseGraph``, link table, GFA export), ``convert`` and the kernels in
``kernels/``: the two kmer kernels, the gathers and pointer jumps that
replace the Pallas gather probes, among them the doubling loop of chain
linking in one launch, and the ruling-set list ranking.

Not ported yet: the summarizer/policy layer (set and eq-class filters,
``CompressionSpec`` variants, rich compression), ``msp``, ``parallel``,
the rest of ``graph``/``clean``/``neighbors``/``dna``, and device unitig
assembly.
"""

from tpu_debruijn_torch.compress import compress_kmers
from tpu_debruijn_torch.convert import table_from_reference, table_to_numpy
from tpu_debruijn_torch.filter import KmerTable, PackedReadBlock, filter_kmers, filter_kmers_streaming
from tpu_debruijn_torch.graph import BaseGraph, DebruijnGraph, from_compress_output
from tpu_debruijn_torch.io import read_fasta, read_fastq, read_fastx, stream_fastx_blocks
from tpu_debruijn_torch.kmer import KmerSpec

__all__ = [
    "BaseGraph",
    "DebruijnGraph",
    "KmerSpec",
    "KmerTable",
    "PackedReadBlock",
    "compress_kmers",
    "filter_kmers",
    "filter_kmers_streaming",
    "from_compress_output",
    "read_fasta",
    "read_fastq",
    "read_fastx",
    "stream_fastx_blocks",
    "table_from_reference",
    "table_to_numpy",
]
