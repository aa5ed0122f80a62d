"""Port parity: the gather and pointer-jump kernel modules against the Pallas
gather probes of scripts/probe_pallas_gather{,2,3}.py.

Each probe's kernel body is repeated here as it stands in its script (the
scripts define them inside ``main``) and run through
``pl.pallas_call(..., interpret=True)`` on the CPU.  Interpret mode accepts
every body but ``k_v3``, whose reshape raises in JAX itself; that test
asserts the error and holds ``gather_rows`` against the row take the body
means, the plain ``jnp.take`` expression.  On a CPU tensor each wrapper
runs its plain PyTorch version.  Integer outputs: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_debruijn_torch.kernels import (
    gather_rows,
    rank_loop,
    successor_walk,
    take_along_axis,
)

M = 1 << 12  # the probes' 2^18, cut for interpret mode
R, L = 64, 128  # the probes' (2048, 128), cut the same way


def _pallas(body, shape, *args):
    out = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(shape, jnp.int32), interpret=True)
    return np.asarray(out(*[jnp.asarray(a) for a in args]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(rng, hi, shape):
    return rng.integers(0, hi, shape).astype(np.int32)


# scripts/probe_pallas_gather.py:60-61 (P1) and :70-71 (P2)
def _k1(idx_ref, tab_ref, out_ref):
    out_ref[:] = tab_ref[idx_ref[:]]


def _k2(idx_ref, tab_ref, out_ref):
    out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)


@pytest.mark.parametrize("body", [_k1, _k2], ids=["p1_bracket", "p2_take"])
def test_p1_p2_gather_matches_probe(rng, body):
    idx, tab = _i32(rng, M, M), _i32(rng, 2**31, M)
    before = gather_rows.launches
    got = gather_rows(_t(tab), _t(idx))
    assert gather_rows.launches == before  # the plain version ran
    assert np.array_equal(got.numpy(), _pallas(body, (M,), idx, tab))


# scripts/probe_pallas_gather.py:80-81 (P3): the shape of _rank_all's gather
def _k3(idx_ref, tab_ref, out_ref):
    out_ref[:] = tab_ref[idx_ref[:], :]


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_p3_row_gather_matches_probe(rng, idx_dtype):
    idx, tab4 = _i32(rng, M, M), _i32(rng, 2**31, (M, 4))
    got = gather_rows(_t(tab4), _t(idx.astype(idx_dtype)))
    assert np.array_equal(got.numpy(), _pallas(_k3, (M, 4), idx, tab4))


# scripts/probe_pallas_gather.py:90-96 (P4): 18 hops through the ORIGINAL table
def _k4(succ_ref, out_ref):
    def body(_, s):
        sc = jnp.clip(s, 0, M - 1)
        nxt = jnp.take(succ_ref[:], sc, axis=0)
        return jnp.where(s >= 0, nxt, s)

    out_ref[:] = jax.lax.fori_loop(0, 18, body, succ_ref[:])


def _successors(rng, kind):
    if kind == "probe":  # probe_pallas_gather.py:102-104: about 1% terminal
        return np.where(rng.random(M) < 0.99, rng.integers(0, M, M), -1).astype(np.int32)
    if kind == "cycles":  # a permutation: every element on a cycle
        return rng.permutation(M).astype(np.int32)
    succ = np.arange(1, M + 1, dtype=np.int32)  # one list longer than 18 hops
    succ[-1] = -1
    return succ


@pytest.mark.parametrize("kind", ["probe", "cycles", "list"])
def test_p4_successor_walk_matches_probe(rng, kind):
    succ = _successors(rng, kind)
    before = successor_walk.launches
    got = successor_walk(_t(succ), 18)
    assert successor_walk.launches == before
    assert np.array_equal(got.numpy(), _pallas(_k4, (M,), succ))


# scripts/probe_pallas_gather2.py:60-61 (V1) and :67-68 (V2)
def _k_v1(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=0)


def _k_v2(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=1)


@pytest.mark.parametrize("axis", [0, 1])
def test_v1_v2_take_along_axis_matches_probe(rng, axis):
    tab2 = _i32(rng, 2**31, (R, L))
    idx = _i32(rng, (R, L)[axis], (R, L))
    before = take_along_axis.launches
    got = take_along_axis(_t(tab2), _t(idx), axis)
    assert take_along_axis.launches == before
    assert np.array_equal(got.numpy(), _pallas((_k_v1, _k_v2)[axis], (R, L), tab2, idx))


# scripts/probe_pallas_gather2.py:74-77 (V3)
def _k_v3(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take(t_ref[:], i_ref[:].reshape(-1), axis=0).reshape(R, L)


def test_v3_take_rows(rng):
    """The body's reshape of an (R*L, L) take to (R, L) raises in JAX (the
    probe's recorded error); the row take it means is gather_rows, C = L."""
    tab2, idx_rows = _i32(rng, 2**31, (R, L)), _i32(rng, R, (R, L))
    with pytest.raises(TypeError, match="reshape"):
        _pallas(_k_v3, (R, L), tab2, idx_rows)
    want = np.asarray(jnp.take(jnp.asarray(tab2), jnp.asarray(idx_rows.reshape(-1)), axis=0))
    got = gather_rows(_t(tab2), _t(idx_rows.reshape(-1)))
    assert got.shape == (R * L, L)
    assert np.array_equal(got.numpy(), want)


# scripts/probe_pallas_gather2.py:85-92 (V4): two take_along_axis in a row
def _k_v4(t_ref, i_ref, o_ref):
    idx = i_ref[:]
    row = idx // L
    lane = idx % L
    rows = jnp.take_along_axis(t_ref[:], row, axis=0)
    o_ref[:] = jnp.take_along_axis(rows, lane, axis=1)


def test_v4_two_take_along_axis_matches_probe(rng):
    tab2, idx_flat = _i32(rng, 2**31, (R, L)), _t(_i32(rng, R * L, (R, L)))
    rows = take_along_axis(_t(tab2), idx_flat // L, 0)
    got = take_along_axis(rows, idx_flat % L, 1)
    assert np.array_equal(got.numpy(), _pallas(_k_v4, (R, L), tab2, idx_flat.numpy()))


# scripts/probe_pallas_gather3.py:44-45 (W1) and :51-53 (W2)
def _w1(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take(t_ref[:], i_ref[:], axis=0)


def _w2(t_ref, i_ref, l_ref, o_ref):
    rows = jnp.take(t_ref[:], i_ref[:, 0], axis=0)
    o_ref[:] = jnp.take_along_axis(rows, l_ref[:], axis=1)


def test_w1_take_axis0_matches_probe(rng):
    tab2, idx_r = _i32(rng, 2**31, (R, L)), _i32(rng, R, R)
    got = gather_rows(_t(tab2), _t(idx_r))
    assert np.array_equal(got.numpy(), _pallas(_w1, (R, L), tab2, idx_r))


def test_w2_composite_matches_probe(rng):
    tab2, idx2, lane2 = _i32(rng, 2**31, (R, L)), _i32(rng, R, (R, L)), _i32(rng, L, (R, L))
    rows = gather_rows(_t(tab2), _t(idx2[:, 0].copy()))
    got = take_along_axis(rows, _t(lane2), 1)
    assert np.array_equal(got.numpy(), _pallas(_w2, (R, L), tab2, idx2, lane2))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("c", [None, 1, 2, 3, 5, 128])
def test_gather_rows_clamps_out_of_range(rng, c, dtype):
    """Any row width, both table types; an index outside [0, M) is clamped."""
    shape = (50,) if c is None else (50, c)
    tab = rng.integers(-(2**31), 2**31, shape).astype(dtype)
    idx = rng.integers(-20, 70, 300)
    got = gather_rows(_t(tab), _t(idx))
    assert got.dtype == _t(tab).dtype
    assert np.array_equal(got.numpy(), tab[np.clip(idx, 0, 49)])


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("words", [3, 5, 6, 8])
def test_gather_rows_plain_row_widths_match_take(rng, words, idx_dtype):
    """Rows of 3-8 int32 words (the count stage's packed observation rows
    are 4 or 8) against jnp.take of the clamped indices."""
    from tpu_debruijn_torch.kernels import gather_rows_plain

    tab = _i32(rng, 2**31, (M, words)) - (1 << 30)
    idx = rng.integers(-40, M + 40, 3 * M).astype(idx_dtype)
    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(np.clip(idx, 0, M - 1)), axis=0))
    assert np.array_equal(gather_rows_plain(_t(tab), _t(idx)).numpy(), want)
    assert np.array_equal(gather_rows(_t(tab), _t(idx)).numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_clamps_out_of_range(rng, axis):
    tab2 = _i32(rng, 2**31, (R, L))
    idx = rng.integers(-5, (R, L)[axis] + 5, (R, L))
    got = take_along_axis(_t(tab2), _t(idx), axis)
    assert np.array_equal(got.numpy(), np.take_along_axis(tab2, np.clip(idx, 0, (R, L)[axis] - 1), axis))


def test_wrappers_refuse_devices_without_a_kernel():
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 4), **meta), torch.zeros(4, **meta))
    with pytest.raises(ValueError):
        take_along_axis(torch.zeros((4, 4), **meta), torch.zeros((4, 4), **meta), 0)
    with pytest.raises(ValueError):
        take_along_axis(torch.zeros((4, 4), dtype=torch.int32), torch.zeros((4, 4), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        successor_walk(torch.zeros(4, **meta), 18)
    with pytest.raises(ValueError):
        rank_loop(torch.zeros((4, 4), **meta), 1)
