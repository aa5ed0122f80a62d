"""FASTA/FASTQ readers feeding the device pipeline.

A copy of ``tpu_debruijn/io/fastx.py``.  Parsing/encoding runs in the
port's host codec when it builds (``io/native.py``), with a pure-Python
fallback; the streaming block reader needs the codec.  Supports plain and
gzip files.
"""

from __future__ import annotations

import gzip
from typing import List, Optional

import numpy as np

from tpu_debruijn_torch.filter import PackedReadBlock
from tpu_debruijn_torch.io import native as N


def _read_bytes(path: str) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def read_fastx(path: str, max_records: Optional[int] = None) -> List[np.ndarray]:
    """Read all sequences of a FASTA/FASTQ(.gz) file as 2-bit code arrays.

    Non-ACGT characters are encoded as 0 (A), matching
    DnaString::from_acgt_bytes (dna_string.rs:228).  With the host codec
    the records are decoded in one native call (``fastx_extract_flat``) and
    returned as views of one buffer, which never overlap.
    """
    data = _read_bytes(path)
    buf = np.frombuffer(data, np.uint8)
    if len(buf) == 0:
        return []
    if N.native_available():
        cap = max_records or max(16, len(buf) // 32)
        rs, re_, n = N.fastx_scan(buf, cap)
        if n > cap:  # rescan with exact capacity
            rs, re_, n = N.fastx_scan(buf, n)
        m = min(n, max_records or n)
        codes, offsets, _ = N.fastx_extract_flat(buf, rs[:m], re_[:m])
        return _split(codes, offsets)
    return _read_fastx_py(data, max_records)


def _split(codes: np.ndarray, offsets: np.ndarray) -> List[np.ndarray]:
    """The records of one flat code buffer, as views of it."""
    m = len(offsets) - 1
    if m == 0:
        return []
    lengths = np.diff(offsets)
    if (lengths == lengths[0]).all():  # equal lengths: the rows, made in C
        return list(codes.reshape(m, int(lengths[0])))
    return [codes[a:b] for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def _read_fastx_py(data: bytes, max_records: Optional[int]) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    if data[:1] == b"@":  # FASTQ
        lines = data.split(b"\n")
        for i in range(1, len(lines), 4):
            if max_records and len(out) >= max_records:
                break
            if i < len(lines) and lines[i]:
                out.append(N.ascii_to_codes(lines[i]))
    else:  # FASTA
        seq: List[bytes] = []
        for line in data.split(b"\n"):
            if line.startswith(b">"):
                if seq:
                    out.append(N.ascii_to_codes(b"".join(seq)))
                    seq = []
                if max_records and len(out) >= max_records:
                    return out
            elif line:
                seq.append(line.strip())
        if seq and (not max_records or len(out) < max_records):
            out.append(N.ascii_to_codes(b"".join(seq)))
    return out


def read_fasta(path: str, max_records: Optional[int] = None) -> List[np.ndarray]:
    return read_fastx(path, max_records)


def read_fastq(path: str, max_records: Optional[int] = None) -> List[np.ndarray]:
    return read_fastx(path, max_records)


def stream_fastx_blocks(path: str, block_reads: int = 8192, width: Optional[int] = None):
    """Stream a FASTA/FASTQ(.gz) file as packed read blocks.

    Yields :class:`tpu_debruijn_torch.filter.PackedReadBlock` items: the
    codec's batch extractor (``db_fastx_extract_batch``) decodes
    ``block_reads`` records per call straight into rows packed 2 bits a
    base, so the feeder does no per-read Python work.  Feed the generator to
    ``filter_kmers_streaming(..., merge="device")``, which uploads the rows
    packed.

    ``width``: row width in bases (rounded up to a multiple of 16); default
    the longest record span in the file.  Longer records are truncated to
    it.
    """
    if not N.native_available():
        raise RuntimeError(
            "stream_fastx_blocks needs the host codec (csrc/host_codec.cpp), "
            "which needs a host C++ compiler to build"
        )
    data = _read_bytes(path)
    buf = np.frombuffer(data, np.uint8)
    if len(buf) == 0:
        return
    cap = max(16, len(buf) // 32)
    rs, re_, n = N.fastx_scan(buf, cap)
    if n > cap:
        rs, re_, n = N.fastx_scan(buf, n)
    rs, re_ = rs[:n], re_[:n]
    if width is None:
        # span length bounds the sequence length (it includes newlines)
        width = int((re_ - rs).max(initial=16))
    width = -(-width // 16) * 16
    for lo in range(0, n, block_reads):
        hi = min(lo + block_reads, n)
        rows, lengths, _bad = N.fastx_extract_batch(buf, rs[lo:hi], re_[lo:hi], width // 4)
        yield PackedReadBlock(rows, lengths, width)
