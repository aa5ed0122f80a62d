"""Port parity: the count stage's packed observation rows.

``filter.count_kmers`` packs each observation into one int32 row (limb
words, exts, label) and moves rows only through ``gather_rows``: the
valid-slot compaction and the sort permutation.  Here the packing round
trips exactly (limbs at and above 2^31, every exts bit, negative labels),
and ``filter_kmers`` equals the JAX package's table for K on both sides of
every limb boundary and every ``data_reduce`` the port has, with labels
that differ per read so that the first and the least label differ.  On a
CPU tensor ``gather_rows`` runs its plain version.  Exact equality.
"""

import numpy as np
import pytest
import torch

from tpu_debruijn import filter as F
from tpu_debruijn_torch import filter as TF
from tpu_debruijn_torch import table_to_numpy
from tpu_debruijn_torch.kernels import gather_rows


def _limbs(rng, shape):
    """int64 limbs in [0, 2^32), a quarter of them at or above 2^31 and
    the extremes present."""
    x = rng.integers(0, 1 << 32, shape, dtype=np.int64)
    x[rng.random(shape) < 0.25] |= 1 << 31
    flat = x.reshape(-1)
    flat[:3] = [0, (1 << 31) - 1, (1 << 32) - 1]
    flat[-1] = 1 << 31
    return x


@pytest.mark.parametrize("labels", ["per_slot", "per_read", "none"])
@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_obs_rows_round_trip(rng, w, labels):
    r, lk = 37, 29
    kmers = _limbs(rng, (r, lk, w))
    exts = rng.integers(0, 256, (r, lk)).astype(np.int32)
    exts.reshape(-1)[:256] = np.arange(256)  # every exts byte
    lab = {
        "per_slot": rng.integers(-(2**31), 2**31, (r, lk)).astype(np.int32),
        "per_read": rng.integers(-(2**31), 0, (r, 1)).astype(np.int32),
        "none": None,
    }[labels]
    rows = TF.pack_obs_rows(torch.from_numpy(kmers), torch.from_numpy(exts),
                            None if lab is None else torch.from_numpy(lab))
    words = TF.obs_row_words(w)
    assert rows.dtype == torch.int32 and rows.shape == (r, lk, words)
    assert words in (4, 8) and words >= w + 2
    assert np.array_equal(TF.row_limbs(rows, w).numpy(), kmers)
    assert np.array_equal(rows[..., w].numpy(), exts)
    pad = w + 1
    if lab is not None:
        assert np.array_equal(rows[..., w + 1].numpy(), np.broadcast_to(lab, (r, lk)))
        pad += 1
    assert not rows[..., pad:].any()
    # a row gather moves the whole observation
    flat = rows.reshape(-1, words)
    perm = torch.from_numpy(rng.permutation(r * lk))
    moved = gather_rows(flat, perm)
    assert np.array_equal(TF.row_limbs(moved, w).numpy(), kmers.reshape(-1, w)[perm.numpy()])


def _reads(rng, n=48, glen=260):
    """Ragged reads of one genome, half reverse-complemented, each with its
    own label (negative ones too) and exts byte."""
    g = rng.integers(0, 4, glen)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, glen - 100))
        r = g[s : s + int(rng.integers(10, 100))].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        out.append((r.astype(np.uint8), int(rng.integers(0, 256)), int(rng.integers(-500, 500))))
    return out


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("data_reduce", ["label_first", "min", "obs_min", "none"])
@pytest.mark.parametrize("k", [15, 16, 17, 31, 32, 33, 47, 63, 64])
def test_count_rows_match_jax(rng, k, data_reduce, stranded):
    reads = _reads(rng)
    kw = dict(stranded=stranded, min_obs=2, report_all=True, data_reduce=data_reduce)
    ref = F.filter_kmers(reads, k, **kw)
    before = gather_rows.launches
    port = TF.filter_kmers(reads, k, device="cpu", **kw)
    assert gather_rows.launches == before  # the plain gathers ran
    got = table_to_numpy(port)
    assert len(got["kmers"]) == len(ref.kmers) > 0
    for key in ("kmers", "exts", "counts", "data"):
        assert np.array_equal(np.asarray(getattr(ref, key)), got[key]), key
    assert np.array_equal(np.asarray(ref.all_kmers), got["all_kmers"])
    if data_reduce in ("label_first", "min"):
        assert got["data"].min() < 0  # the labels' order mattered
