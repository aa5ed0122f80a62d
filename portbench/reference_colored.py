"""The plain reference of a colored assembly, in plain PyTorch.

Independent of the program under test: it imports nothing of it and reads
nothing it made.  From labelled reads alone (each read's label a small
non-negative int, its "color") it works out, for k <= 31 and unstranded
kmers, with :mod:`portbench.reference`'s helpers:

- the kmer table after ``min_obs`` on each kmer's total count over every
  label: its count (saturating at 65535), the OR of its observations'
  exts, and its *set*, the distinct labels it was observed with
  (CountFilterSet, filter.rs:68-101), held as a bit mask, bit ``b`` for
  label ``b``;
- the exts after the censor (filter.rs:280-306);
- the unitigs under the set join: maximal paths joined where the one-
  extension test of :func:`reference.partners` holds and the two kmers'
  sets are equal (ScmapCompress, compression.rs:68-98);
- each unitig's set, the union of its kmers' sets (compression.rs:40-65),
  as one row a kmer: (its code, its unitig's mask);
- the tips of that graph, and the graph after cleaning them, re-joined
  again only across equal sets (compression.rs:291-349), with its sets;
- its GFA links.

Everything runs on the reads' device, in bulk.
"""

from __future__ import annotations

import torch

from portbench import reference as R

_I64 = torch.int64
MAX_LABEL = 62  # a set is an int64 bit mask


def _or_planes(values: torch.Tensor, run: torch.Tensor, n_runs: int, bits: int) -> torch.Tensor:
    """The OR of ``values`` over each run, bit by bit."""
    out = torch.zeros(n_runs, dtype=_I64, device=values.device)
    for b in range(bits):
        plane = torch.zeros_like(out).scatter_reduce_(0, run, (values >> b) & 1, "amax")
        out |= plane << b
    return out


def count_sets(reads: torch.Tensor, labels: torch.Tensor, k: int, min_obs: int,
               sets_reduce: str = "or") -> dict:
    """The colored kmer table: sorted canonical ``codes``, ``counts``,
    ``exts`` and ``sets`` (label masks) of the kmers seen ``min_obs`` times
    or more in all, and ``distinct``, the number of distinct kmers before
    ``min_obs``.  ``sets_reduce`` "first" keeps the label of each kmer's
    first observation alone: the control, which breaks the sets'
    guarantee."""
    if labels.numel() and (int(labels.min()) < 0 or int(labels.max()) > MAX_LABEL):
        raise ValueError(f"the reference takes labels 0..{MAX_LABEL}")
    codes, exts = R.observations(reads, k)
    n_obs = codes.shape[0]
    lk = reads.shape[1] - k + 1
    bit = (torch.ones((), dtype=_I64, device=reads.device)
           << labels.to(_I64)).repeat_interleave(lk)
    codes, order = torch.sort(codes, stable=True)
    exts, bit = exts[order], bit[order]
    del order
    head = torch.ones(n_obs, dtype=torch.bool, device=codes.device)
    head[1:] = codes[1:] != codes[:-1]
    starts = torch.nonzero(head).flatten()
    counts = torch.diff(starts, append=torch.tensor([n_obs], device=codes.device))
    run = torch.cumsum(head, 0) - 1
    del head
    ored = _or_planes(exts, run, starts.shape[0], 8)
    del exts
    if sets_reduce == "first":
        sets = bit[starts]
    else:
        sets = _or_planes(bit, run, starts.shape[0], int(labels.max()) + 1 if labels.numel() else 0)
    del run, bit
    keep = counts >= min_obs
    return {"codes": codes[starts][keep], "counts": counts[keep].clamp(max=R.COUNT_MAX),
            "exts": ored[keep], "sets": sets[keep], "distinct": int(starts.shape[0])}


def popcount(masks: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(masks)
    for b in range(MAX_LABEL + 1):
        out += (masks >> b) & 1
    return out


def same_set(nbr, sets: torch.Tensor):
    """:func:`reference.neighbors`' tuple with a neighbour counted as there
    only where its set equals the kmer's: :func:`reference.partners` on it
    joins only across equal sets."""
    idx, found, side = nbr
    return idx, found & (sets[idx] == sets[None]), side


def unitig_sets(codes, sets, partner, valid) -> torch.Tensor:
    """One row a ``valid`` kmer, sorted: (its code, the OR of the sets of
    its unitig's kmers).  A unitig is named by the lesser of its two free
    sides (:func:`reference.chain_ends`); a kmer on a cycle, which has none,
    keeps its own set (a cycle's joins all hold equal sets)."""
    e_right, e_left, _, cyc = R.chain_ends(partner)
    uid = torch.where(cyc, 2 * codes.shape[0] + torch.arange(codes.shape[0], device=codes.device),
                      torch.minimum(e_right, e_left))
    bits = int(sets.max()).bit_length() if sets.numel() else 0
    _, inv = torch.unique(uid, return_inverse=True)
    union = _or_planes(sets, inv, int(inv.max()) + 1 if inv.numel() else 0, bits)[inv]
    return R._sorted_rows(torch.stack([codes, union], 1)[valid])


def assemble(reads: torch.Tensor, labels: torch.Tensor, cfg: dict, sets_reduce: str = "or") -> dict:
    """Everything the colored comparison holds the program to, from the
    labelled reads: :func:`reference.assemble`'s keys (the table with its
    ``sets``, the censored exts, the unitigs, tips, cleaned graph and its
    edges) under the set join, and ``unitig_sets``, ``cleaned_sets`` and
    ``n_pairs`` (the table's (kmer, label) pairs)."""
    k, min_obs = cfg["k"], cfg["min_obs"]
    if cfg.get("stranded") or k > 31:
        raise ValueError("the reference covers unstranded kmers of k <= 31")
    table = count_sets(reads, labels, k, min_obs, sets_reduce)
    codes, sets = table["codes"], table["sets"]
    n = codes.shape[0]
    nbr = R.neighbors(codes, k)
    joinable = same_set(nbr, sets)
    every = torch.ones(n, dtype=torch.bool, device=codes.device)
    censored = R.restrict_exts(table["exts"], nbr, every)
    partner, one_sided = R.partners(censored, joinable, every)
    e_right, e_left, nk, cyc = R.chain_ends(partner)
    pc = R.popcount4(codes.device)
    a, b = pc[R.side_mask(censored, e_right)], pc[R.side_mask(censored, e_left)]
    max_kmers = cfg["tip_max_bases"] - k  # len = kmers + k - 1 < tip_max_bases
    tip = (((a == 0) & (b <= 1)) | ((b == 0) & (a <= 1))) & (nk <= max_kmers) & ~cyc
    kept = ~tip
    clean_exts = R.restrict_exts(censored, nbr, kept)
    partner2, one_sided2 = R.partners(clean_exts, joinable, kept)
    return {
        "table": table, "censored_exts": censored,
        "unitigs": R.unitig_repr(codes, censored, partner, every),
        "unitig_sets": unitig_sets(codes, sets, partner, every),
        "cleaned": R.unitig_repr(codes, clean_exts, partner2, kept),
        "cleaned_sets": unitig_sets(codes, sets, partner2, kept),
        "edges": R.edges(codes, clean_exts, partner2, kept, nbr),
        "n_pairs": int(popcount(sets).sum()),
        "n_unitigs": int((partner < 0).sum()) // 2,
        "n_tip_unitigs": int((partner[tip] < 0).sum()) // 2,
        "n_cleaned": int((partner2[kept] < 0).sum()) // 2,
        "cycle_kmers": int(cyc.sum()), "one_sided_joins": one_sided + one_sided2,
    }
