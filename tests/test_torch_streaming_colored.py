"""Port parity: filter_kmers_streaming's colored device merge, its empty
results and its refusals, against the JAX package on the CPU.

``colored=True`` counts (kmer, label) pairs and returns (table,
pair_label, split).  The label orders as a uint32 below the kmer limbs, so a
negative color sorts last within its kmer, as in the JAX package.  Exact
equality of the table and both arrays.
"""

import numpy as np
import pytest
import torch

from tpu_debruijn import filter as F
from tpu_debruijn_torch import filter as TF

from test_torch_streaming_device import KS, _genome_reads
from test_torch_streaming_host import _reads, _same


def _same_triple(ref, port, what=""):
    _same(ref[0], port[0], what)
    for i, name, dtype in ((1, "pair_label", torch.int32), (2, "split", torch.int64)):
        assert port[i].device.type == "cpu" and port[i].dtype == dtype, name
        assert np.array_equal(np.asarray(ref[i]), port[i].numpy()), f"{what}: {name}"


@pytest.mark.parametrize("k", KS)
def test_colored_matches_jax(rng, k):
    reads = _genome_reads(rng, labels=(0, 1, 2, -3, 2**31 - 1))
    stranded = k in (17, 32)
    for min_obs in (1, 2):
        kw = dict(stranded=stranded, min_obs=min_obs, data_reduce="none", merge="device",
                  colored=True, chunk_reads=32)
        ref = F.filter_kmers_streaming(iter(reads), k, init_capacity=8192, **kw)
        port = TF.filter_kmers_streaming(iter(reads), k, device="cpu", **kw)
        assert len(ref[0]) > 0 and (np.asarray(ref[1]) == -3).any()
        _same_triple(ref, port, f"K={k} min_obs={min_obs}")
        # the negative color sorts last within its kmer
        split, labels = port[2].numpy(), port[1].numpy()
        for i in np.nonzero(np.diff(split) > 1)[0][:50]:
            colors = labels[split[i] : split[i + 1]].astype(np.uint32)
            assert (np.diff(colors) > 0).all()


def test_empty_input_matches_jax():
    for kw in (dict(), dict(merge="device", data_reduce="none")):
        _same(F.filter_kmers_streaming([], 31, **kw),
              TF.filter_kmers_streaming([], 31, device="cpu", **kw), str(kw))
    # reads all shorter than K
    short = [(np.zeros(10, np.uint8), 0, 0)]
    _same(F.filter_kmers_streaming(short, 31), TF.filter_kmers_streaming(short, 31, device="cpu"))
    kw = dict(merge="device", data_reduce="none", colored=True)
    ref = F.filter_kmers_streaming(iter([]), 31, **kw)
    port = TF.filter_kmers_streaming(iter([]), 31, device="cpu", **kw)
    _same_triple(ref, port, "colored")
    assert port[0].kmers.shape == (0, 2)


def test_refusals_match_jax(rng):
    """Each refusal of the JAX package raises ValueError in the port too."""
    reads = _reads(rng)[:8]
    block = TF.PackedReadBlock(np.zeros((4, 10), np.uint8), np.full(4, 40, np.int32), 40)
    jblock = F.PackedReadBlock(block.packed, block.lengths, 40)
    cases = [
        (reads, dict(colored=True)),                                   # colored needs the device merge
        (reads, dict(merge="device", data_reduce="label_first")),      # device merge takes 'none' only
        (reads, dict(merge="device", data_reduce="min", colored=True)),
        ([block], dict()),                                             # packed blocks need the device merge
        ([block], dict(merge="device", data_reduce="none")),           # width not a multiple of 16
        (reads, dict(data_reduce="mode")),                             # no such data_reduce
    ]
    for i, (items, kw) in enumerate(cases):
        jitems = [jblock] if items and items[0] is block else items
        with pytest.raises(ValueError):
            F.filter_kmers_streaming(jitems, 31, **kw)
        with pytest.raises(ValueError):
            TF.filter_kmers_streaming(items, 31, device="cpu", **kw)
