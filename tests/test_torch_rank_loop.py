"""The pointer-doubling loop (``rank_loop`` and its plain version
``rank_loop_plain``) against ``tpu_debruijn.compress._rank_all``, the JAX
package's ``lax.while_loop``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
carry is compared exactly in every lane, cycle states included: the plain
loop is the JAX loop step for step, so even the dist and end lanes that the
callers never read on a cycle (tpu_debruijn/compress.py:243-245) agree.  The
count of rounds run is compared with the JAX loop's own count, taken by
running its ``cond`` and ``body`` one step at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn_torch.kernels import pointer_jump as P

MS = [0, 1, 2, 1000, 1 << 16]
KINDS = ["forest", "in_tree", "cycles"]


def _succ(rng, m, kind):
    """Random lists of about 40 states over m states; ``in_tree`` joins the
    last list's terminal into the first list's terminal (a state with two
    predecessors), ``cycles`` closes every other list into a cycle."""
    succ = np.full(m, -1, np.int64)
    if m < 2:
        return succ
    cuts = np.sort(rng.choice(np.arange(1, m), size=max(1, m // 40), replace=False))
    parts = np.split(rng.permutation(m), cuts)
    for j, part in enumerate(parts):
        succ[part[:-1]] = part[1:]
        if kind == "cycles" and j % 2:
            succ[part[-1]] = part[0]
    if kind == "in_tree":
        succ[parts[-1][-1]] = parts[0][-1]
    return succ


def _inputs(m, kind):
    rng = np.random.default_rng(m + 7 * KINDS.index(kind))
    succ = _succ(rng, m, kind)
    mnmo = rng.integers(0, 1 << 30, m)
    dist0 = rng.integers(-(2**31), 2**31, m)  # large enough to wrap int32
    end0 = np.where(succ < 0, rng.integers(0, 1 << 20, m), -1)
    return succ, mnmo, dist0, end0


def _carry(succ, mnmo, dist0, end0):
    return torch.from_numpy(np.stack([succ, dist0, mnmo, end0], 1).reshape(-1, 4)).to(torch.int32)


def _jax(args):
    out = C._rank_all(*[jnp.asarray(a.astype(np.int32)) for a in args])
    return np.stack([np.asarray(a) for a in out], 1).reshape(-1, 4)


def _jax_rounds(monkeypatch, args) -> int:
    """Rounds the JAX loop runs: its cond and body, one step at a time."""
    counts = []

    def while_loop(cond, body, init):
        val, n = init, 0
        while bool(cond(val)):
            val, n = body(val), n + 1
        counts.append(n)
        return val

    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    C._rank_all(*[jnp.asarray(a.astype(np.int32)) for a in args])
    return counts[0]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", MS)
def test_rank_loop_plain_matches_jax_rank_all(m, kind):
    args = _inputs(m, kind)
    x = _carry(*args)
    got, _ = P.rank_loop_plain(x, P._full_rounds(m))
    want = _jax(args)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(x, _carry(*args))  # the input is left as it was


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", MS)
def test_rank_loop_stops_where_jax_loop_stops(monkeypatch, m, kind):
    args = _inputs(m, kind)
    want = _jax_rounds(monkeypatch, args)
    x = _carry(*args)
    _, t = P.rank_loop_plain(x, P._full_rounds(m))
    assert t == want
    before = P.rank_loop.launches
    carry, rounds = P.rank_loop(x, P._full_rounds(m))
    assert P.rank_loop.launches == before  # a CPU tensor runs the plain loop
    assert rounds.dtype == torch.int32 and rounds.tolist() == [want]
    assert P.rank_loop.last_rounds is rounds
    assert np.array_equal(carry.numpy(), _jax(args))
    if kind == "cycles" and m > 2:
        assert t == P._full_rounds(m)  # a cycle never resolves


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_rank_loop_one_round_is_rank_round_plain(kind, early_exit):
    x = _carry(*_inputs(1000, kind))
    want, _ = P.rank_round_plain(x)
    got, t = P.rank_loop_plain(x, 1, early_exit)
    assert t == 1 and torch.equal(got, want)
    got, rounds = P.rank_loop(x, 1, early_exit)
    assert rounds.tolist() == [1] and torch.equal(got, want)


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("kind", ["forest", "in_tree"])
def test_rank_loop_without_early_exit_runs_every_round(kind, extra):
    """A resolved row never changes, so the rounds after the early exit
    leave the carry as it was."""
    x = _carry(*_inputs(1000, kind))
    full = P._full_rounds(1000) + extra
    stopped, t = P.rank_loop_plain(x, full)
    ran, n = P.rank_loop_plain(x, full, early_exit=False)
    assert t < full and n == full
    assert torch.equal(stopped, ran)


@pytest.mark.parametrize("kind", KINDS)
def test_rank_lists_cpu_matches_jax(kind):
    args = _inputs(5000, kind)
    assert np.array_equal(P.rank_lists(_carry(*args)).numpy(), _jax(args))


def test_rank_loop_refuses_bad_input():
    with pytest.raises(ValueError):
        P.rank_loop(torch.zeros((4, 4), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        P.rank_loop(torch.zeros((4, 4), dtype=torch.int32, device="meta"), 3)
