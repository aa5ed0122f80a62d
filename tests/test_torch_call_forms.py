"""The port's call forms against the JAX package's.

A call written for ``tpu_debruijn`` must run on ``tpu_debruijn_torch``:
every public function and method the two packages share accepts the
reference's positional parameters, by name and in order, unless it is on
:data:`BY_DESIGN` (the static-shape and TPU-switch arguments the port drops),
where the port's own parameters are written out so that any further drift
fails here.  ``assemble_unitigs``, ``assemble_unitigs_flat`` and
``link_chains_ordered`` are called in both packages with the reference's
positional arguments on seeded inputs, and their outputs compared exactly.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_debruijn import compress as C
from tpu_debruijn import filter as F
from tpu_debruijn.oracle import ref as O
from tpu_debruijn_torch import compress as TC

# the modules both packages have, by their name under the package
MODULES = (
    "", "bases", "clean", "compress", "dna", "exts", "filter", "graph", "io", "io.fastx",
    "io.native", "kernels", "kernels.canonical", "kernels.extract_canonical", "kmer", "msp",
    "neighbors", "parallel", "parallel.mesh", "parallel.multihost", "parallel.shard", "sorting",
)

# name -> (the port's positional parameters, why they are not the reference's)
BY_DESIGN = {
    "compress.assemble_unitigs_device": (
        ("spec", "kmers", "chains", "contrib", "counts"),
        "no cap_bases: the output is sized from the chains, not a static capacity"),
    "compress.compress_kmer_table_device": (
        ("spec", "stranded", "kmers", "exts", "join_labels", "first_pos", "order_cap"),
        "no n_valid: tables are not padded"),
    "compress.infer_exts_device": (
        ("spec", "stranded", "kmers"), "no n_valid: tables are not padded"),
    "compress.resolve_edges": (
        ("spec", "stranded", "kmers", "exts", "join_labels", "return_candidates"),
        "no n_valid: tables are not padded"),
    "filter.canonicalize": (
        ("spec", "kmers", "exts", "stranded"),
        "no use_pallas: a CUDA tensor always runs the kernel"),
    "filter.remove_censored_exts_device": (
        ("spec", "stranded", "kmers", "exts", "all_kmers"),
        "no n_valid or all_n: tables and censuses are not padded"),
    "parallel.mesh.make_mesh": (
        ("n_shards", "device"), "logical shards of one device, not a mesh of devices"),
    "sorting.lex_eq": (("a", "b"), "limb forms, not the key-array forms"),
    "sorting.lex_lt": (("a", "b"), "limb forms, not the key-array forms"),
    "sorting.run_starts": (
        ("sorted_limbs",), "one (n, W) limb tensor and no validity: invalid rows are dropped"),
    "sorting.searchsorted_limbs": (
        ("sorted_limbs", "query_limbs"), "no n_valid: tables are not padded"),
    "sorting.segment_min": (
        ("vals", "seg", "n_seg", "reduce"),
        "the segment count and reduce in place of the padded n and init"),
    "sorting.sort_with_payload": (
        ("limbs", "payloads"), "one (n, W) limb tensor in place of key arrays and their count"),
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _positional(fn) -> tuple:
    return tuple(p.name for p in inspect.signature(fn).parameters.values() if p.kind in _POSITIONAL)


def _module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}" if name else pkg)


def _unwrap(attr):
    return attr.__func__ if isinstance(attr, (staticmethod, classmethod)) else attr


def _shared():
    """(qualified name, reference function, port function) for every
    public function defined in a shared module, and every public method
    (and ``__init__``) of a shared class, that both packages have."""
    out = []
    for name in MODULES:
        ref, port = _module("tpu_debruijn", name), _module("tpu_debruijn_torch", name)
        for attr in sorted(dir(ref)):
            if attr.startswith("_") or not hasattr(port, attr):
                continue
            a, b = getattr(ref, attr), getattr(port, attr)
            # a module's own definitions; the package roots' re-exports too
            if getattr(a, "__module__", None) != ref.__name__ and name != "":
                continue
            qual = f"{name}.{attr}" if name else attr
            if inspect.isfunction(a) and inspect.isfunction(b):
                out.append((qual, a, b))
            elif inspect.isclass(a) and inspect.isclass(b) and a.__module__ == ref.__name__:
                for meth in sorted(vars(a)):
                    if (meth.startswith("_") and meth != "__init__") or not hasattr(b, meth):
                        continue
                    ma = _unwrap(inspect.getattr_static(a, meth))
                    mb = _unwrap(inspect.getattr_static(b, meth))
                    if inspect.isfunction(ma) and inspect.isfunction(mb):
                        out.append((f"{qual}.{meth}", ma, mb))
    return out


SHARED = _shared()


@pytest.mark.parametrize("qual,ref,port", SHARED, ids=[s[0] or "root" for s in SHARED])
def test_port_accepts_reference_positional_parameters(qual, ref, port):
    want, got = _positional(ref), _positional(port)
    if qual in BY_DESIGN:
        port_params, why = BY_DESIGN[qual]
        assert why and got == port_params, f"{qual} drifted from its by-design form ({why})"
        assert got[: len(want)] != want, f"{qual} now takes the reference's form: drop it from BY_DESIGN"
    else:
        assert got[: len(want)] == want, f"{qual}: the reference takes {want}, the port {got}"


def test_by_design_list_names_shared_functions():
    names = {s[0] for s in SHARED}
    assert set(BY_DESIGN) <= names
    assert len(SHARED) > 250  # every module was walked


# ---------------------------------------------------------------------------
# the two repaired call forms, called positionally in both packages
# ---------------------------------------------------------------------------


def _repeat_reads(rng, n_reads: int = 120):
    """Reads of a genome tiled from a few chunks: a branchy graph of many
    unitigs, half of the reads reverse-complemented."""
    pool = [np.asarray(O.random_dna(rng, 60), np.uint8) for _ in range(8)]
    genome = np.concatenate([pool[i] for i in rng.integers(0, len(pool), 40)])
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, len(genome) - 100))
        r = genome[s : s + 100].copy()
        if rng.random() < 0.5:
            r = (3 - r)[::-1].copy()
        reads.append((r, 0, int(rng.integers(0, 5))))
    return reads


def _reference_chains(table, stranded: bool):
    """The JAX package's chains of a table over its pow2-padded arrays, as
    its ``compress_kmers`` computes them; the padded kmers and data."""
    n = len(table.kmers)
    kmers, exts, data = C._pad_table_pow2(table.spec, n, table.kmers, table.exts,
                                          np.asarray(table.data, np.int32))
    chains, u_exts, contrib = C._compress_jit(table.spec, stranded, False, kmers, exts,
                                              jnp.int32(n), data)
    return np.asarray(kmers), np.asarray(data), chains, u_exts, contrib


@pytest.mark.parametrize("data_reduce", ["sum_sat_u16", "max", "min", "sum"])
@pytest.mark.parametrize("k,stranded", [(16, True), (31, False)])
def test_assemble_unitigs_reference_positional(rng, k, stranded, data_reduce):
    """Padded per-item arrays (padding has uid -1), as the reference's
    compress_kmers passes them."""
    table = F.filter_kmers(_repeat_reads(rng), k, stranded=stranded, min_obs=1,
                           data_reduce="max")
    kmers, data, chains, u_exts, contrib = _reference_chains(table, stranded)
    assert kmers.shape[0] > len(table.kmers)
    args = (table.spec, kmers, *(np.asarray(getattr(chains, f)) for f in (
        "uid", "pos", "flip", "length", "first_item", "first_flip")),
        int(chains.n_unitigs), np.asarray(u_exts), np.asarray(contrib), data)
    assert int(chains.n_unitigs) > 5
    want = C.assemble_unitigs_flat(*args, data_reduce=data_reduce)
    got = TC.assemble_unitigs_flat(*args, data_reduce=data_reduce)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    want_nodes = C.assemble_unitigs(*args, data_reduce=data_reduce)
    got_nodes = TC.assemble_unitigs(*args, data_reduce=data_reduce)
    assert len(got_nodes) == len(want_nodes) == int(chains.n_unitigs)
    for (gs, ge, gd), (ws, we, wd) in zip(got_nodes, want_nodes):
        assert np.array_equal(gs, ws) and ge == we and gd == wd


def _edges(table, stranded: bool):
    n = len(table.kmers)
    e = C.resolve_edges(table.spec, stranded, jnp.asarray(table.kmers),
                        jnp.asarray(table.exts), jnp.int32(n))
    return [np.asarray(e[f]) for f in ("partner_l", "partner_r", "in_l", "in_r")]


def _chain_cols(ch):
    """Chains as comparable lists: uid and flip of every item, position of
    the items in a unitig (the port writes 0 elsewhere), the per-unitig
    arrays."""
    nu = int(ch.n_unitigs)
    uid = np.asarray(ch.uid).astype(np.int64)
    live = uid >= 0
    return (
        uid.tolist(),
        np.asarray(ch.flip).astype(np.int64).tolist(),
        np.asarray(ch.pos).astype(np.int64)[live].tolist(),
        nu,
        [np.asarray(getattr(ch, f))[:nu].astype(np.int64).tolist()
         for f in ("length", "first_item", "last_item", "first_flip", "last_flip")],
    )


@pytest.mark.parametrize("mask", ["none", "all", "unitigs", "isolated"])
@pytest.mark.parametrize("stranded", [False, True])
def test_link_chains_ordered_reference_positional(rng, stranded, mask):
    """The reference's seven positional arguments, with a ``valid`` mask
    that drops whole unitigs (chains of invalid items linked to each other)
    or single items: invalid items rank last and belong to no unitig."""
    k = 21
    table = F.filter_kmers(_repeat_reads(rng), k, stranded=stranded, min_obs=1,
                           data_reduce="obs_min")
    n = len(table.kmers)
    pl, pr, il, ir = _edges(table, stranded)
    full = C.link_chains(*(jnp.asarray(a) for a in (pl, pr, il, ir)), jnp.ones(n, bool))
    uid = np.asarray(full.uid)
    nu = int(full.n_unitigs)
    assert nu > 5
    valid = np.ones(n, bool)
    if mask == "unitigs":
        valid = ~np.isin(uid, rng.choice(nu, size=nu // 3, replace=False))
    elif mask == "isolated":  # the single-item unitigs: nothing points at them
        lone = np.nonzero((pl < 0) & (pr < 0))[0]
        assert lone.size
        valid[lone[::2]] = False
    fp = np.asarray(table.data, np.int64)
    cap = n
    want, w_over = C.link_chains_ordered(
        *(jnp.asarray(a) for a in (pl, pr, il, ir)), jnp.asarray(valid),
        jnp.asarray(fp.astype(np.int32)), cap)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    got, g_over = TC.link_chains_ordered(
        t(pl), t(pr), t(il), t(ir), None if mask == "none" else torch.from_numpy(valid),
        t(fp), cap)
    assert not bool(w_over) and g_over is False
    assert _chain_cols(got) == _chain_cols(want)
    assert (np.asarray(got.uid)[~valid] == -1).all()
    assert (got.pos.numpy()[got.uid.numpy() < 0] == 0).all()
    # the plain linker under the same mask labels the same chains
    plain = TC.link_chains(t(pl), t(pr), t(il), t(ir),
                           None if mask == "none" else torch.from_numpy(valid))
    assert _chain_cols(plain) == _chain_cols(got)


@pytest.mark.parametrize("stranded", [False, True])
def test_link_chains_ordered_valid_overflow(rng, stranded):
    """Past the interval cap the port falls back to link_chains under the
    same mask; the reference flags the overflow too."""
    table = F.filter_kmers(_repeat_reads(rng), 21, stranded=stranded, min_obs=1,
                           data_reduce="obs_min")
    n = len(table.kmers)
    pl, pr, il, ir = _edges(table, stranded)
    valid = np.ones(n, bool)
    valid[np.nonzero((pl < 0) & (pr < 0))[0]] = False
    fp = np.asarray(table.data, np.int64)
    _, w_over = C.link_chains_ordered(*(jnp.asarray(a) for a in (pl, pr, il, ir)),
                                      jnp.asarray(valid), jnp.asarray(fp.astype(np.int32)), 2)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    got, g_over = TC.link_chains_ordered(t(pl), t(pr), t(il), t(ir), torch.from_numpy(valid),
                                         t(fp), 2)
    assert bool(w_over) and g_over is True
    plain = TC.link_chains(t(pl), t(pr), t(il), t(ir), torch.from_numpy(valid))
    assert torch.equal(got.uid, plain.uid) and (got.uid.numpy()[~valid] == -1).all()
