"""Port parity: filter_kmers_streaming's host merge (the default) against
the JAX package's filter_kmers_streaming and filter_kmers, on the CPU, for
K = 15, 16 and 17 (the other K in test_torch_streaming_host_mid.py and
test_torch_streaming_host_wide.py, which import the helpers here).

Every data_reduce the host merge takes, min_obs 1 and 2, chunk_reads 7 and
16, stranded both ways; the reads are ragged, half reverse-complemented,
carry their own exts byte and label (negative ones too) and include
poly-T reads and reads shorter than K.  Exact equality of every column.
Each case compiles one JAX count program per chunk shape: the row width is
fixed by ``read_len_cap``, and min_obs 2 reuses min_obs 1's programs.
"""

import numpy as np
import pytest

from tpu_debruijn import filter as F
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import table_to_numpy

DATA_REDUCE = ["label_first", "min", "max", "sum", "none"]
READ_LEN_CAP = 100


def _reads(rng, n=36, glen=260):
    """Ragged reads of one genome, half reverse-complemented, each with its
    own exts byte and label, plus poly-T reads and one read of 12 bases."""
    g = rng.integers(0, 4, glen)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, glen - READ_LEN_CAP))
        r = g[s : s + int(rng.integers(20, READ_LEN_CAP + 1))].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        out.append((r.astype(np.uint8), int(rng.integers(0, 256)), int(rng.integers(-2**31, 2**31))))
    out += [(np.full(70, 3, np.uint8), 0, 7), (np.full(40, 3, np.uint8), 0x81, -9),
            (rng.integers(0, 4, 12).astype(np.uint8), 3, 5)]
    t = rng.integers(0, 4, 90).astype(np.uint8)
    t[20:70] = 3
    out.append((t, 0, 11))
    return out


def _same(ref, port, what=""):
    """The JAX table (an object with numpy columns, or a dict) equals the
    port's, column by column; the port's lies on the CPU."""
    got = table_to_numpy(port)
    assert port.kmers.device.type == "cpu"
    for key in ("kmers", "exts", "counts", "data"):
        want = ref[key] if isinstance(ref, dict) else getattr(ref, key)
        assert np.array_equal(np.asarray(want), got[key]), f"{what}: {key}"


def _filtered(table, min_obs):
    """The columns of a JAX min_obs = 1 table whose counts reach min_obs:
    filter_kmers' table at that min_obs."""
    keep = np.asarray(table.counts) >= min_obs
    return {key: np.asarray(getattr(table, key))[keep] for key in ("kmers", "exts", "counts", "data")}


def _host_case(rng, k, stranded, data_reduce):
    reads = _reads(rng)
    one = F.filter_kmers(reads, k, stranded=stranded, min_obs=1, data_reduce=data_reduce)
    assert len(one) > 0
    for chunk_reads in (7, 16):
        for min_obs in (1, 2):
            kw = dict(stranded=stranded, min_obs=min_obs, data_reduce=data_reduce,
                      chunk_reads=chunk_reads, read_len_cap=READ_LEN_CAP)
            ref = F.filter_kmers_streaming(reads, k, **kw)
            port = TF.filter_kmers_streaming(reads, k, device="cpu", **kw)
            what = f"K={k} chunk_reads={chunk_reads} min_obs={min_obs}"
            _same(ref, port, what + " against JAX streaming")
            _same(_filtered(one, min_obs), port, what + " against JAX filter_kmers")
    if stranded:  # the poly-T kmer is in the table
        polyt = np.full(port.spec.w, 0xFFFFFFFF, np.uint32)
        polyt[0] = port.spec.top_mask
        assert (table_to_numpy(port)["kmers"] == polyt).all(axis=1).any()


@pytest.mark.parametrize("data_reduce", DATA_REDUCE)
@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [15, 16, 17])
def test_host_merge_matches_jax(rng, k, stranded, data_reduce):
    _host_case(rng, k, stranded, data_reduce)


def test_host_merge_obs_min(rng):
    """'obs_min' passes through one chunk (its slot indices count the JAX
    package's row width) and is refused, as in JAX, once two chunks merge."""
    reads = _reads(rng)
    kw = dict(stranded=False, data_reduce="obs_min", chunk_reads=len(reads))
    _same(F.filter_kmers_streaming(reads, 31, **kw),
          TF.filter_kmers_streaming(reads, 31, device="cpu", **kw), "one chunk")
    kw["chunk_reads"] = 16
    with pytest.raises(ValueError):
        F.filter_kmers_streaming(reads, 31, **kw)
    with pytest.raises(ValueError):
        TF.filter_kmers_streaming(reads, 31, device="cpu", **kw)
