"""The plain reference against a frozen numpy count, and its pieces."""

import numpy as np
import pytest
import torch

from portbench import compare as CP
from portbench import generate
from portbench import reference as R

CFG = {"genome": {"length": 3000},
       "reads": {"length": 150, "coverage": 10, "rc_share": 0.5, "window": 160,
                 "indel_rate": 1e-3, "substitution_rate": [0.001, 0.009]},
       "k": 31, "min_obs": 2, "tip_max_bases": 62}


# chip_smoke.py's numpy count of canonical codes, frozen here as a second witness
def numpy_rc(v, k):
    m = np.uint64
    x = ~v
    x = ((x & m(0x3333333333333333)) << m(2)) | ((x >> m(2)) & m(0x3333333333333333))
    x = ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4)) | ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F))
    x = ((x & m(0x00FF00FF00FF00FF)) << m(8)) | ((x >> m(8)) & m(0x00FF00FF00FF00FF))
    x = ((x & m(0x0000FFFF0000FFFF)) << m(16)) | ((x >> m(16)) & m(0x0000FFFF0000FFFF))
    x = (x << m(32)) | (x >> m(32))
    return x >> m(64 - 2 * k)


def plain_count(reads, k):
    n, l = reads.shape
    lk = l - k + 1
    v = np.zeros((n, lk), np.uint64)
    for j in range(k):
        v <<= np.uint64(2)
        v |= reads[:, j : j + lk]
    v = v.reshape(-1)
    v = np.minimum(v, numpy_rc(v, k))
    v.sort()
    head = np.ones(v.shape[0], bool)
    head[1:] = v[1:] != v[:-1]
    starts = np.nonzero(head)[0]
    return v[starts], np.diff(np.append(starts, v.shape[0]))


@pytest.mark.parametrize("k", [4, 15, 16, 17, 30, 31])
def test_rc_codes_against_bases(k):
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, (500, k))
    code = lambda b: sum(int(x) << (2 * (k - 1 - i)) for i, x in enumerate(b))
    v = torch.tensor([code(b) for b in bases])
    want = torch.tensor([code(3 - b[::-1]) for b in bases])
    assert torch.equal(R.rc_codes(v, k), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("min_obs", [1, 2])
def test_table_against_plain_count(seed, min_obs):
    reads = generate.error_reads(CFG, seed, "cpu")
    t = R.count_table(reads, 31, min_obs)
    codes, counts = plain_count(reads.numpy(), 31)
    keep = counts >= min_obs
    assert t["distinct"] == codes.shape[0]
    assert np.array_equal(t["codes"].numpy().astype(np.uint64), codes[keep])
    assert np.array_equal(t["counts"].numpy(), counts[keep])


def test_exts_are_the_or_of_neighbours():
    reads = generate.error_reads(CFG, 2, "cpu")
    t = R.count_table(reads, 31, 1)
    want = {}
    k = 31
    for r in reads.tolist():
        for j in range(len(r) - k + 1):
            kmer = r[j : j + k]
            e = (1 << r[j - 1] if j else 0) | ((1 << r[j + k]) << 4 if j + k < len(r) else 0)
            rc = [3 - b for b in kmer[::-1]]
            if rc < kmer:  # lexicographic on bases = numeric on codes
                kmer = rc
                e = int(R.exts_rc(torch.tensor([e]))[0])
            key = sum(b << (2 * (k - 1 - i)) for i, b in enumerate(kmer))
            want[key] = want.get(key, 0) | e
    got = dict(zip(t["codes"].tolist(), t["exts"].tolist()))
    assert got == want


def test_unitigs_of_a_clean_genome_are_one():
    # error-free reads of a random genome: one unitig, its two ends free
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 2000)
    starts = rng.integers(0, len(g) - 150 + 1, 200)
    reads = torch.from_numpy(np.stack([g[s : s + 150] for s in starts]).astype(np.uint8))
    reads = torch.cat([reads, torch.from_numpy(g[None, :150].astype(np.uint8)),
                       torch.from_numpy(g[None, -150:].astype(np.uint8))])
    out = R.assemble(reads, {**CFG, "min_obs": 1}, censor=True)
    assert out["n_unitigs"] == 1 and out["cycle_kmers"] == 0
    flat = g.astype(np.uint8)
    want = CP.seq_repr(flat, [0], [len(g)], None, 31, "cpu")
    got = out["unitigs"]
    assert CP.row_diff(got["kmers"], want["kmers"]) == 0
    assert CP.row_diff(got["links"], want["links"]) == 0
    assert CP.row_diff(got["ends"][:, :1], want["ends"]) == 0


def test_row_diff_counts_multisets():
    a = torch.tensor([[1, 2], [1, 2], [3, 4]])
    b = torch.tensor([[1, 2], [5, 6]])
    assert CP.row_diff(a, b) == 3 and CP.row_diff(a, a) == 0
