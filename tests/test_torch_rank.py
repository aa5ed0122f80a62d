"""The ruling-set list ranking and the tiled kmer extraction, as plain
PyTorch transcriptions of their CUDA kernels (``rank_lists_rulers_plain``,
``extract_canonical_tiled_plain``), against the JAX package on the CPU and
against the port's plain versions.

Ranking: exact on every state whose path ends; on cycle states, which the
callers read only for ``succ >= 0`` and the cycle minimum
(tpu_debruijn/compress.py:243-245), the same sign and the same ``mnmo``.
Extraction: exact on every slot (integer outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn import kmer as JK
from tpu_debruijn.kernels.extract_canonical import extract_canonical_fused
from tpu_debruijn_torch import kmer as TK
from tpu_debruijn_torch.kernels import pointer_jump as P
from tpu_debruijn_torch.kernels.extract_canonical import (
    extract_canonical_plain,
    extract_canonical_tiled_plain,
)

MS = [1, 2, 77, 1000, 50_000]
SPACINGS = [2, 8, 32]


def _chains(rng, m, n_cycles=0):
    """Random lists over m states (about 9 states each), the first
    ``n_cycles`` of them closed into cycles."""
    succ = np.full(m, -1, np.int64)
    if m < 3:
        return np.array([1, -1], np.int64)[-m:]
    cuts = np.sort(rng.choice(np.arange(1, m), size=max(1, m // 9), replace=False))
    for part in np.split(rng.permutation(m), cuts):
        succ[part[:-1]] = part[1:]
        if n_cycles and len(part) > 1:
            succ[part[-1]] = part[0]
            n_cycles -= 1
    return succ


def _ruler_free_cycles(rng, m, spacing):
    """One long chain over most states, plus cycles of length 1, 2, 3 and
    about spacing / 2 made only of states that are not rulers."""
    plain = np.nonzero(~P.hashed_ruler(torch.arange(m), spacing).numpy())[0]
    lens = [n for n in (1, 2, 3, max(4, spacing // 2)) if n <= len(plain)]
    picked = rng.permutation(plain)[: sum(lens)]
    succ = np.full(m, -1, np.int64)
    rest = rng.permutation(np.setdiff1d(np.arange(m), picked))
    succ[rest[:-1]] = rest[1:]
    a = 0
    for n in lens:
        c = picked[a : a + n]
        succ[c] = np.roll(c, -1)
        a += n
    return succ


def _inputs(rng, m, kind, spacing):
    """(succ, mnmo, dist0 or None, end0 or None) as int64 numpy arrays."""
    if kind == "forest":
        succ = _chains(rng, m)
    elif kind == "cycles":
        succ = _chains(rng, m, n_cycles=5)
    elif kind == "chain":  # one long list, the shape of an E. coli table's chains
        order = rng.permutation(m)
        succ = np.full(m, -1, np.int64)
        succ[order[:-1]] = order[1:]
    else:  # ruler-free cycles
        succ = _ruler_free_cycles(rng, m, spacing)
    mnmo = rng.integers(0, 1 << 30, m)
    if kind in ("forest", "chain"):
        return succ, mnmo, None, None
    # the contracted form: seeded weights (large enough to wrap int32) and exits
    dist0 = rng.integers(-(2**31), 2**31, m)
    end0 = np.where(succ < 0, rng.integers(0, 1 << 20, m), -1)
    return succ, mnmo, dist0, end0


def _carry(succ, mnmo, dist0, end0):
    m = len(succ)
    if dist0 is None:
        dist0 = (succ >= 0).astype(np.int64)
    if end0 is None:
        end0 = np.where(succ == -1, np.arange(m), -1)
    return torch.from_numpy(np.stack([succ, dist0, mnmo, end0], 1)).to(torch.int32)


def _same_ranking(got, want):
    """Exact where the path ends; on cycles the sign and the minimum."""
    got, want = np.asarray(got), np.asarray(want)
    res = want[:, 0] < 0
    assert np.array_equal(got[res], want[res])
    assert (got[~res, 0] >= 0).all()
    assert np.array_equal(got[~res, 2], want[~res, 2])


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("kind", ["forest", "chain", "cycles", "ruler_free"])
@pytest.mark.parametrize("m", MS)
def test_ruling_set_matches_jax_rank_all(m, kind, spacing):
    rng = np.random.default_rng(m * 31 + spacing)
    args = _inputs(rng, m, kind, spacing)
    x = _carry(*args)
    got = P.rank_lists_rulers_plain(x, spacing)
    want = C._rank_all(*[jnp.asarray(a.astype(np.int32)) for a in args if a is not None])
    want = np.stack([np.asarray(a) for a in want], 1)
    _same_ranking(got.numpy(), want)
    # and against the port's own plain version, doubling
    _same_ranking(got.numpy(), P.rank_lists_plain(x).numpy())
    assert torch.equal(x, _carry(*args))  # the input is left as it was


@pytest.mark.parametrize("spacing", SPACINGS)
def test_ruling_set_cycles_without_rulers(spacing):
    """Every cycle state lies on a cycle with no ruler: all are ranked apart."""
    rng = np.random.default_rng(spacing)
    m = 3000
    succ = _ruler_free_cycles(rng, m, spacing)
    x = _carry(succ, rng.integers(0, 1 << 30, m), None, None)
    got = P.rank_lists_rulers_plain(x, spacing)
    want = P.rank_lists_plain(x)
    assert int((want[:, 0] >= 0).sum()) >= 6  # the cycles of length 1, 2 and 3 at least
    _same_ranking(got.numpy(), want.numpy())


@pytest.mark.parametrize("shape", ["in_tree", "out_of_range"])
def test_ruling_set_takes_the_round_path(shape):
    """Two predecessors of one state, or a successor past the carry: the
    ruling set does not apply and doubling ranks the input."""
    rng = np.random.default_rng(7)
    m = 500
    succ = _chains(rng, m)
    if shape == "in_tree":
        live = np.nonzero(succ >= 0)[0]
        succ[live[1]] = succ[live[0]]
    else:
        succ[np.nonzero(succ >= 0)[0][0]] = m + 3
    x = _carry(succ, rng.integers(0, 1 << 30, m), None, None)
    assert torch.equal(P.rank_lists_rulers_plain(x, 4), P.rank_lists_plain(x))


def test_rank_lists_cpu_is_doubling():
    rng = np.random.default_rng(8)
    x = _carry(_chains(rng, 1000, 3), rng.integers(0, 1 << 30, 1000), None, None)
    before = P.rank_lists.launches
    assert torch.equal(P.rank_lists(x), P.rank_lists_plain(x))
    assert P.rank_lists.launches == before


def test_rank_lists_refuses_bad_input():
    with pytest.raises(ValueError):
        P.rank_lists(torch.zeros((4, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        P.rank_lists_rulers_plain(torch.zeros((4, 4), dtype=torch.int32), 3)


@pytest.mark.parametrize("stranded", [False, True])
@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64])
def test_tiled_extraction_matches_pallas(rng, k, stranded):
    """Whole-row pieces, L a multiple of 16 and not; ragged lengths."""
    spec = TK.KmerSpec(k)
    for r, l in ((9, 96), (5, k + 3)):
        bases = rng.integers(0, 4, (r, l)).astype(np.uint8)
        bases[0, : min(l, 40)] = 3  # a poly-T run
        lengths = rng.integers(k, l + 1, r).astype(np.int32)
        lengths[1] = l
        seq_exts = rng.integers(0, 256, r).astype(np.int32)
        tb, tl, ts = (torch.from_numpy(a) for a in (bases, lengths, seq_exts))
        got = extract_canonical_tiled_plain(spec, tb, tl, ts, stranded)
        plain = extract_canonical_plain(spec, tb, tl, ts, stranded)
        for g, p in zip(got, plain):  # every slot, invalid ones too
            assert torch.equal(g, p)
        jk, je, jv = extract_canonical_fused(JK.KmerSpec(k), bases, lengths, seq_exts, stranded=stranded)
        wv = np.asarray(jv)
        assert np.array_equal(wv, got[2].numpy())
        assert np.array_equal(np.asarray(jk)[wv], TK.to_numpy(got[0])[wv])
        assert np.array_equal(np.asarray(je)[wv], got[1].numpy()[wv])


@pytest.mark.parametrize("seg_max", [1, 7, 16, 33])
@pytest.mark.parametrize("k", [1, 17, 31, 33, 64])
def test_tiled_extraction_pieces(rng, k, seg_max):
    """Rows cut into pieces of ``seg_max`` slots, as the kernel cuts rows
    longer than SEG_MAX."""
    spec = TK.KmerSpec(k)
    r, l = 6, 150
    bases = torch.from_numpy(rng.integers(0, 4, (r, l)).astype(np.uint8))
    lengths = torch.from_numpy(rng.integers(k, l + 1, r).astype(np.int32))
    seq_exts = torch.from_numpy(rng.integers(0, 256, r).astype(np.int32))
    for stranded in (False, True):
        got = extract_canonical_tiled_plain(spec, bases, lengths, seq_exts, stranded, seg_max)
        for g, p in zip(got, extract_canonical_plain(spec, bases, lengths, seq_exts, stranded)):
            assert torch.equal(g, p)
