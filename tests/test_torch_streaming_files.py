"""Port parity: the streaming inputs, against the JAX package on the CPU.

``stream_fastx_blocks`` on FASTA, FASTQ and gzip files yields the JAX
package's packed blocks, block by block, and the device merge turns them
into the JAX table; 2-D read blocks, with and without lengths, count as
their per-read tuples do; ``memory_gb`` sizes the chunks.  Exact equality.
"""

import gzip

import numpy as np
import pytest

from tpu_debruijn import filter as F
from tpu_debruijn import io as IO
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import io as TIO

from test_torch_streaming_host import _same

_LUT = np.frombuffer(b"ACGT", np.uint8)


def _write(path, reads, fmt):
    """FASTA with its sequence over two lines, or FASTQ; gzip by suffix."""
    lines = []
    for i, r in enumerate(reads):
        s = bytes(_LUT[r]).decode()
        if fmt == "fasta":
            lines.append(f">r{i}\n{s[:37]}\n{s[37:]}\n")
        else:
            lines.append(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    text = "".join(lines).replace("ACG", "AcN", 1)  # a lower-case base and a non-ACGT one
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(text)


@pytest.mark.parametrize("name", ["reads.fa", "reads.fq", "reads.fq.gz"])
def test_stream_fastx_blocks_match_jax(rng, tmp_path, name):
    assert TIO.native_available()
    g = rng.integers(0, 4, 700)
    reads = []
    for _ in range(150):
        s = int(rng.integers(0, 600))
        reads.append(g[s : s + int(rng.integers(40, 100))])
    path = str(tmp_path / name)
    _write(path, reads, "fasta" if name.endswith(".fa") else "fastq")
    ref = list(IO.stream_fastx_blocks(path, block_reads=64))
    got = list(TIO.stream_fastx_blocks(path, block_reads=64))
    assert len(got) == len(ref) == 3
    for a, b in zip(ref, got):
        assert isinstance(b, TF.PackedReadBlock)
        assert b.width == a.width and b.width % 16 == 0
        assert np.array_equal(b.packed, a.packed) and np.array_equal(b.lengths, a.lengths)
    kw = dict(stranded=False, min_obs=1, merge="device", data_reduce="none", chunk_reads=50)
    want = F.filter_kmers_streaming(iter(ref), 21, init_capacity=8192, **kw)
    _same(want, TF.filter_kmers_streaming(iter(got), 21, device="cpu", **kw), name)
    # and one-batch counting of the same reads, as read_fastx gives them
    one = TF.filter_kmers([(r, 0, 0) for r in TIO.read_fastx(path)], 21, stranded=False,
                          min_obs=1, data_reduce="none", device="cpu")
    _same(want, one, "read_fastx")


def test_streaming_blocks_match_per_read(rng):
    """test_filter.py's block case through the port: 2-D blocks with per-read
    labels, with and without lengths, equal the per-read tuples and the JAX
    package, across widths that grow the row cap."""
    k = 21
    blocks = [rng.integers(0, 4, (37, 60)).astype(np.uint8) for _ in range(3)]
    labels = [np.arange(i * 37, (i + 1) * 37, dtype=np.int32) for i in range(3)]
    per_read = [(b[j], 0, int(lab[j])) for b, lab in zip(blocks, labels) for j in range(37)]
    kw = dict(stranded=False, min_obs=2, chunk_reads=16)
    ref = F.filter_kmers_streaming([(b, 0, lab) for b, lab in zip(blocks, labels)], k, **kw)
    rows = TF.filter_kmers_streaming(per_read, k, device="cpu", **kw)
    blocked = TF.filter_kmers_streaming([(b, 0, lab) for b, lab in zip(blocks, labels)], k,
                                        device="cpu", **kw)
    _same(ref, rows, "per read")
    _same(ref, blocked, "blocks")
    # ragged lengths through the optional fourth element, then a wider block
    lens = rng.integers(k, 61, 37).astype(np.int32)
    wide = rng.integers(0, 4, (5, 130)).astype(np.uint8)
    ragged = [(blocks[0][j, : lens[j]], 3, 0) for j in range(37)] + [(r, 3, 0) for r in wide]
    items = [(blocks[0], 3, 0, lens), (wide, 3, 0)]
    kw = dict(stranded=False, min_obs=1, chunk_reads=16, data_reduce="sum")
    ref = F.filter_kmers_streaming(items, k, **kw)
    _same(ref, TF.filter_kmers_streaming(ragged, k, device="cpu", **kw), "ragged per read")
    _same(ref, TF.filter_kmers_streaming(items, k, device="cpu", **kw), "ragged blocks")


def test_streaming_memory_gb_knob(rng):
    """A tiny budget forces chunks of 256 reads (the floor); the table still
    equals the JAX package's and one-batch counting."""
    from tpu_debruijn.oracle import ref as O

    k = 16
    reads = []
    for c in O.random_contigs(rng):
        c = np.asarray(c, np.uint8)
        for s in range(0, max(1, len(c) - 40), 17):
            reads.append((c[s : s + 40], 0, 0))
    assert len(reads) > 256
    kw = dict(stranded=False, min_obs=2, read_len_cap=64, memory_gb=2e-4)
    ref = F.filter_kmers_streaming(reads, k, **kw)
    _same(ref, TF.filter_kmers_streaming(reads, k, device="cpu", **kw))
    _same(ref, TF.filter_kmers(reads, k, stranded=False, min_obs=2, device="cpu"))
    assert 2e-4 * 1e9 / TF.count_bytes_per_read(TF.KmerSpec(k), 64) < 256
    # the reckoning grows with the read and the limbs, the label a limb
    # of the colored count's key
    spec = TF.KmerSpec(31)
    assert TF.count_bytes_per_read(spec, 150) < TF.count_bytes_per_read(spec, 250)
    assert TF.count_bytes_per_read(spec, 150) < TF.count_bytes_per_read(TF.KmerSpec(63), 182)
    assert TF.count_bytes_per_read(spec, 150) < TF.count_bytes_per_read(spec, 150, colored=True)
