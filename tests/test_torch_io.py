"""Port parity: ``read_fastx`` and its one native call, against the JAX package on the CPU.

The port's ``read_fastx``, ``read_fastq`` and ``read_fasta`` give the JAX
package's arrays (dtype, length, bytes) on each file shape below, at every
``max_records``; the native path gives what the pure-Python fallback gives
where the two read a file alike; the records are views of one buffer that
never overlap; one call of ``fastx_extract_flat`` decodes what a
``fastx_extract`` call a record decodes.  Exact equality.
"""

import gzip

import numpy as np
import pytest

from tpu_debruijn import io as IO
from tpu_debruijn_torch import io as TIO
from tpu_debruijn_torch.io import fastx as TFX
from tpu_debruijn_torch.io import native as TN

_LUT = np.frombuffer(b"ACGT", np.uint8)


def _bases(rng, n):
    return bytes(_LUT[rng.integers(0, 4, n)]).decode()


def _fastq(seqs, eol="\n"):
    return "".join(f"@r{i}{eol}{s}{eol}+{eol}{'I' * len(s)}{eol}" for i, s in enumerate(seqs))


def _equal_fq(rng):
    return _fastq([_bases(rng, 150) for _ in range(40)])


def _ragged_fq(rng):
    seqs = [_bases(rng, int(n)) for n in rng.integers(1, 200, 30)]
    seqs[7] = ""  # an empty record
    return _fastq(seqs).rstrip("\n")  # and no newline at the end


def _one_short_fq(rng):
    return _fastq([_bases(rng, 150) for _ in range(20)] + [_bases(rng, 149)])  # one read trimmed


def _crlf_fq(rng):
    return _fastq([_bases(rng, int(n)) for n in rng.integers(20, 120, 25)], eol="\r\n")


def _multiline_fa(rng):
    out = []
    for i, n in enumerate(rng.integers(1, 300, 20)):
        s = _bases(rng, int(n))
        out.append(f">r{i} some description\n" + "\n".join(s[j:j + 60] for j in range(0, len(s), 60)) + "\n")
    return "".join(out)


def _n_lower_fq(rng):
    seqs = []
    for n in rng.integers(50, 160, 30):
        s = np.frombuffer(_bases(rng, int(n)).encode(), np.uint8).copy()
        s[rng.random(len(s)) < 0.2] = ord("N")
        low = rng.random(len(s)) < 0.3
        s[low] |= 0x20  # lower case, "n" included
        s[rng.random(len(s)) < 0.02] = ord("X")
        seqs.append(s.tobytes().decode())
    return _fastq(seqs)


def _all_empty_fq(rng):
    return _fastq([""] * 5)


# name -> (file name, text maker, whether the pure-Python fallback reads it as
# the native path does: the fallback keeps a FASTQ line's "\r" as a code and
# drops empty records, in the JAX package as in the port)
SHAPES = {
    "fastq_equal": ("reads.fq", _equal_fq, True),
    "fastq_ragged_empty": ("reads.fq", _ragged_fq, False),
    "fastq_one_short": ("reads.fq", _one_short_fq, True),
    "fastq_crlf": ("reads.fq", _crlf_fq, False),
    "fasta_multiline": ("reads.fa", _multiline_fa, True),
    "fastq_gz": ("reads.fq.gz", _equal_fq, True),
    "fasta_gz": ("reads.fa.gz", _multiline_fa, True),
    "fastq_n_lower": ("reads.fq", _n_lower_fq, True),
    "fastq_all_empty": ("reads.fq", _all_empty_fq, False),
}


def _write(tmp_path, rng, shape):
    name, make, _ = SHAPES[shape]
    path = str(tmp_path / name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(make(rng).encode())
    return path


def _same_arrays(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, np.ndarray) and g.ndim == 1, i
        assert g.dtype == w.dtype == np.uint8, i
        assert len(g) == len(w) and g.tobytes() == w.tobytes(), i


def _n_records(path):
    return len(IO.read_fastx(path))


@pytest.mark.parametrize("limit", ["all", "below", "at", "above"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_read_fastx_matches_jax(rng, tmp_path, shape, limit):
    path = _write(tmp_path, rng, shape)
    n = _n_records(path)
    assert n >= 5
    max_records = {"all": None, "below": n // 2, "at": n, "above": n + 3}[limit]
    want = IO.read_fastx(path, max_records=max_records)
    _same_arrays(TIO.read_fastx(path, max_records=max_records), want)
    reader = TIO.read_fasta if ".fa" in path else TIO.read_fastq
    jax_reader = IO.read_fasta if ".fa" in path else IO.read_fastq
    _same_arrays(reader(path, max_records=max_records), jax_reader(path, max_records=max_records))


@pytest.mark.parametrize("limit", [None, 3])
@pytest.mark.parametrize("shape", sorted(s for s, (_, _, alike) in SHAPES.items() if alike))
def test_native_matches_python_fallback(rng, tmp_path, shape, limit):
    path = _write(tmp_path, rng, shape)
    got = TIO.read_fastx(path, max_records=limit)
    _same_arrays(got, TFX._read_fastx_py(TFX._read_bytes(path), limit))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_records_do_not_overlap(rng, tmp_path, shape):
    path = _write(tmp_path, rng, shape)
    reads = TIO.read_fastx(path)
    before = [r.copy() for r in reads]
    for i, r in enumerate(reads):
        if len(r):
            r[:] = (r + 1) & 3  # write into one record ...
            for j, (other, old) in enumerate(zip(reads, before)):  # ... and no other moves
                if j != i:
                    assert np.array_equal(other, old), (i, j)
            r[:] = before[i]


def _spans(path):
    buf = np.frombuffer(TFX._read_bytes(path), np.uint8)
    rs, re_, n = TN.fastx_scan(buf, 1 << 12)
    return buf, rs[:n], re_[:n]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_extract_flat_matches_per_record(rng, tmp_path, shape):
    buf, rs, re_ = _spans(_write(tmp_path, rng, shape))
    codes, offsets, bad = TN.fastx_extract_flat(buf, rs, re_)
    want, want_bad, want_offsets = [], 0, [0]
    for s, e in zip(rs.tolist(), re_.tolist()):
        c, b = TN.fastx_extract(buf, s, e)
        want.append(c)
        want_bad += b
        want_offsets.append(want_offsets[-1] + len(c))
    assert offsets.dtype == np.int64 and offsets.tolist() == want_offsets
    assert codes.dtype == np.uint8 and codes.tobytes() == b"".join(c.tobytes() for c in want)
    assert bad == want_bad
    if shape == "fastq_n_lower":
        assert bad > 0


def test_extract_flat_no_records_and_bad_spans():
    buf = np.frombuffer(b"@r\nACGT\n+\nIIII\n", np.uint8)
    codes, offsets, bad = TN.fastx_extract_flat(buf, np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert len(codes) == 0 and offsets.tolist() == [0] and bad == 0
    for rs, re_ in [([3], [2]), ([-1], [4]), ([3], [len(buf) + 1])]:
        with pytest.raises(ValueError):
            TN.fastx_extract_flat(buf, np.array(rs), np.array(re_))


@pytest.mark.parametrize("shape", ["fastq_equal", "fastq_ragged_empty", "fasta_multiline"])
def test_read_fastx_one_native_call(rng, tmp_path, shape):
    path = _write(tmp_path, rng, shape)
    flat, one = TN.fastx_extract_flat.calls, TN.fastx_extract.calls
    reads = TIO.read_fastx(path)
    assert len(reads) >= 2
    assert TN.fastx_extract_flat.calls == flat + 1
    assert TN.fastx_extract.calls == one
