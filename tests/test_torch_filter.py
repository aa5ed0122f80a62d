"""Port parity: tpu_debruijn_torch.filter.filter_kmers against the JAX
package's filter_kmers on the same reads, run on the CPU; tables must be
identical (kmers, exts, counts, data and the census)."""

import numpy as np
import pytest

from tpu_debruijn import filter as F
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import table_to_numpy


def _reads(rng, n=40, glen=300, poly_t=False):
    g = rng.integers(0, 4, glen)
    out = []
    for i in range(n):
        s = int(rng.integers(0, glen - 100))
        r = g[s : s + int(rng.integers(60, 100))].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        out.append((r.astype(np.uint8), int(rng.integers(0, 256)), i))
    if poly_t:
        out += [(np.full(70, 3, np.uint8), 0, 7), (np.full(40, 3, np.uint8), 0x81, 9)]
        t = rng.integers(0, 4, 90).astype(np.uint8)
        t[20:70] = 3
        out.append((t, 0, 11))
    return out


def _same_tables(ref, port, report_all):
    got = table_to_numpy(port)
    for key in ("kmers", "exts", "counts", "data"):
        assert np.array_equal(np.asarray(getattr(ref, key)), got[key]), key
    if report_all:
        assert np.array_equal(np.asarray(ref.all_kmers), got["all_kmers"])
    else:
        assert port.all_kmers is None


@pytest.mark.parametrize("data_reduce", ["label_first", "none", "max", "sum"])
@pytest.mark.parametrize("min_obs", [1, 2])
@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [16, 31, 47, 63])
def test_filter_kmers_matches_jax(rng, k, stranded, min_obs, data_reduce):
    reads = _reads(rng)
    report_all = min_obs == 2
    kw = dict(stranded=stranded, min_obs=min_obs, report_all=report_all, data_reduce=data_reduce)
    ref = F.filter_kmers(reads, k, **kw)
    port = TF.filter_kmers(reads, k, device="cpu", **kw)
    assert port.kmers.device.type == "cpu"
    assert len(port) == len(ref) > 0
    _same_tables(ref, port, report_all)


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [16, 32, 48, 64])
def test_filter_kmers_poly_t_matches_jax(rng, k, stranded):
    """Poly-T kmers at K = 16/32/48/64 equal the JAX sort's all-ones
    sentinel value; the port has no sentinel and must agree."""
    reads = _reads(rng, n=20, poly_t=True)
    for data_reduce in ("none", "label_first"):
        kw = dict(stranded=stranded, min_obs=1, report_all=True, data_reduce=data_reduce)
        ref = F.filter_kmers(reads, k, **kw)
        port = TF.filter_kmers(reads, k, device="cpu", **kw)
        _same_tables(ref, port, True)
        polyt = np.full((1, port.spec.w), 0xFFFFFFFF, np.uint32)
        polyt[0, 0] = port.spec.top_mask
        assert (table_to_numpy(port)["kmers"] == polyt).all(axis=1).any() == stranded


def test_filter_kmers_counts_saturate(rng):
    reads = [(np.zeros(120, np.uint8), 0, 0)] * 700  # 73,500 poly-A observations
    reads = reads + _reads(rng, n=10)
    ref = F.filter_kmers(reads, 16, stranded=False, min_obs=2)
    port = TF.filter_kmers(reads, 16, stranded=False, min_obs=2, device="cpu")
    _same_tables(ref, port, False)
    assert int(port.counts.max()) == 65535


def test_filter_kmers_skips_short_reads():
    reads = [(np.zeros(10, np.uint8), 0, 0)]
    port = TF.filter_kmers(reads, 31, device="cpu", report_all=True)
    assert len(port) == 0 and port.all_kmers.shape == (0, 2)
    with pytest.raises(ValueError):
        TF.filter_kmers([(np.zeros(40, np.uint8), 0, 0)], 31, device="cpu", data_reduce="mode")
