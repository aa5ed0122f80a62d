"""Path compression: kmer table -> unitigs, by list ranking.

Counterpart of ``tpu_debruijn/compress.py`` (rust-debruijn's
CompressFromHash, compression.rs:355-615), with the same three steps:

1. **Edge resolution** (:func:`resolve_edges`): per kmer and direction,
   the reference's merge conditions as vector masks: a unique extension,
   the target present, no palindromes when unstranded, a unique incoming
   extension at the target, and the mutual reverse edge.  The 2n
   candidate targets are canonicalized by the canonical kernel
   (``kernels/canonical.py``) and found by one search of the sorted table.
2. **Chain linking** (:func:`link_chains`): a successor over the 2n
   (kmer, orientation) states is list-ranked to give every kmer its
   unitig, position and orientation.  Cycles are cut at the minimum kmer,
   where the reference's seed loop would break them, and re-ranked.
   On CUDA the ranking is the ruling-set kernels of ``rank_lists``
   (``kernels/pointer_jump.py``).  :func:`link_chains_ordered` gives the
   same result by ranking only a contracted graph of read-adjacent
   intervals, given each kmer's first-occurrence index.
3. **Emission** (:func:`_emit_chains`, shared by both linkers): of the two
   mirror traversals of a chain, the one where the chain's minimum kmer
   keeps its stored orientation; unitig ids in increasing chain-minimum
   order.

Unitig sequences are assembled from the chain labels on the device
(:func:`assemble_unitigs_device`: only the bases and the per-unitig arrays
cross to the host) under every policy; :func:`assemble_unitigs` assembles
them on the host from chain labels pulled there (the read-ordered path's
:func:`assemble_chains`).  :func:`stitch_device` joins node sequences along
node-level chains on the device, into packed words (``graph.compress_graph``,
the shard stitch); :func:`stitch_flat` is its host form.

The policy layer (compression.rs:34-98): :class:`CompressionSpec` and its
two shipped forms fold per-kmer data along unitigs with a named reduction
or a closure and restrict joins to equal labels; :func:`compress_kmers_rich`
folds arbitrary payload objects under an arbitrary join test evaluated on
the host over the candidate edges; :func:`compress_kmers_color_sets` folds
label sets as arrays, by one sort of the (unitig, label) pairs.

The JAX package's TPU workarounds (gather-cliff padding, pow2 table
padding, packed int32 lanes, the assembly's capacity retries) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu_debruijn_torch import exts as E
from tpu_debruijn_torch import filter as F
from tpu_debruijn_torch import kmer as KM
from tpu_debruijn_torch import sorting as S
from tpu_debruijn_torch.kernels.canonical import canonicalize
from tpu_debruijn_torch.kernels.gather import gather_rows
from tpu_debruijn_torch.kernels.pointer_jump import rank_lists
from tpu_debruijn_torch.kmer import KmerSpec
from tpu_debruijn_torch.stages import Stages

LEFT, RIGHT = E.LEFT, E.RIGHT


def resolve_edges(spec: KmerSpec, stranded: bool, kmers: torch.Tensor, exts: torch.Tensor,
                  join_labels: Optional[torch.Tensor] = None, return_candidates: bool = False):
    """Per-kmer merge partners for both directions of a sorted unique table.

    Returns dict with, for d in {l, r}: ``partner_d`` (n,) int64 target
    row or -1, and ``in_d`` (n,) int64 stored side (0/1) of the target the
    edge enters.  With ``join_labels`` ((n,) int32 or int64), an edge joins
    only rows of equal labels (ScmapCompress's join test).  With
    ``return_candidates``, the edges before the mutuality pass: every merge
    condition applied but a host-evaluated join test
    (:func:`compress_kmers_rich`).
    """
    n = kmers.shape[0]
    dev = kmers.device
    idx_self = torch.arange(n, device=dev)
    uniq, cands = {}, []
    for d in (LEFT, RIGHT):
        u, base = E.unique_extension(exts, d)
        uniq[d] = u
        ext = KM.extend_left if d == LEFT else KM.extend_right
        cands.append(ext(spec, kmers, base.to(torch.int64)))
    queries = torch.cat(cands, dim=0)  # (2n, W): left candidates, then right
    if stranded:
        flip = torch.zeros(2 * n, dtype=torch.bool, device=dev)
        pal_self = torch.zeros(n, dtype=torch.bool, device=dev)
        pal_next = flip
    else:
        # one launch canonicalizes the table rows (for the palindrome test
        # of each kmer itself) and the 2n candidates; a row is a palindrome
        # iff it was flipped and still equals itself
        rows = torch.cat([kmers, queries], dim=0)
        canon, _, fl = canonicalize(
            spec, rows, torch.zeros(rows.shape[0], dtype=torch.int32, device=dev)
        )
        pal = fl & KM.eq(canon, rows)
        pal_self, pal_next = pal[:n], pal[n:]
        queries, flip = canon[n:], fl[n:]

    jj, ffound, jexts = S.join_limbs(kmers, queries, exts)
    partners, ins = {}, {}
    for d in (LEFT, RIGHT):
        sl = slice(d * n, (d + 1) * n)
        j = torch.where(ffound[sl], jj[sl], -1)
        # side of the target the edge comes in on (compression.rs:419)
        in_d = torch.where(flip[sl], d, 1 - d)
        ok = (
            uniq[d]
            & ffound[sl]
            & (j != idx_self)
            & ~pal_self
            & ~pal_next[sl]
            & (E.num_ext_dir(jexts[sl], in_d) == 1)
        )
        if join_labels is not None:
            ok &= join_labels == gather_rows(join_labels, j)  # j = -1 reads row 0, masked
        partners[d] = torch.where(ok, j, -1)
        ins[d] = in_d
    if return_candidates:
        return {"partner_l": partners[LEFT], "in_l": ins[LEFT],
                "partner_r": partners[RIGHT], "in_r": ins[RIGHT]}
    return _enforce_mutual(partners, ins)


def _enforce_mutual(partners, ins):
    """Keep only edges whose reverse half-edge points back (the
    incoming-unique symmetry of compression.rs:422-435)."""
    n = partners[LEFT].shape[0]
    idx_self = torch.arange(n, device=partners[LEFT].device)
    pmat = torch.stack([partners[LEFT], partners[RIGHT]], dim=1)
    out = {}
    for d, name in ((LEFT, "l"), (RIGHT, "r")):
        j = partners[d]
        rp = gather_rows(pmat, j)  # j = -1 reads row 0, masked below
        rev = torch.where(ins[d] == LEFT, rp[:, 0], rp[:, 1])
        out[f"partner_{name}"] = torch.where((j >= 0) & (rev == idx_self), j, -1)
        out[f"in_{name}"] = ins[d]
    return out


@dataclasses.dataclass
class Chains:
    """Result of chain linking over n items.

    Per item: ``uid`` (unitig id), ``pos`` (position from the unitig's
    left end), ``flip`` (reverse-complemented in the unitig).  Per unitig
    (length ``n_unitigs``): ``length`` in items, and the first and last
    items with their orientations.
    """

    uid: torch.Tensor
    pos: torch.Tensor
    flip: torch.Tensor
    n_unitigs: int
    length: torch.Tensor
    first_item: torch.Tensor
    last_item: torch.Tensor
    first_flip: torch.Tensor
    last_flip: torch.Tensor


def _empty_chains(device) -> Chains:
    """The chains of no item."""
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return Chains(uid=z, pos=z, flip=z.bool(), n_unitigs=0, length=z, first_item=z, last_item=z,
                  first_flip=z, last_flip=z)


def _succ_states(partner_l, partner_r, in_l, in_r):
    """Directed successor over 2n (item, orientation) walker states.

    State 2i+o = item i in orientation o (0 stored, 1 flipped), moving
    right along the unitig: o=0 exits the stored R side, o=1 the stored L
    side, and the side it enters the target by sets the target's
    orientation.
    """
    def one(j, side_in):
        return torch.where(j >= 0, 2 * j + (side_in != LEFT).to(j.dtype), -1)

    return torch.stack([one(partner_r, in_r), one(partner_l, in_l)], dim=1).reshape(-1)


def _rank_all(succ: torch.Tensor, mnmo: torch.Tensor, dist0=None, end0=None):
    """List ranking: (succ_final, dist_to_end, mnmo_min, end_state) per
    state, int64.

    ``dist0``/``end0`` seed each state's edge weight and terminal id (the
    contracted ranking of :func:`link_chains_ordered` seeds interval lengths
    and exit states); by default a live edge weighs 1 and a terminal state
    ends at itself.

    The carry is one (m, 4) int32 matrix ranked by :func:`rank_lists`: on
    CUDA a ruling set (``csrc/list_rank.cu``), on the CPU pointer doubling.
    Both give doubling's result on every state whose path ends.  Cycle
    states keep ``succ >= 0`` and get the cycle's minimum mnmo; their
    dist/end are garbage and the caller re-ranks them.
    """
    m = succ.shape[0]
    if m >= 1 << 31:
        raise ValueError(f"_rank_all: {m} states do not fit the int32 carry")
    if dist0 is None:
        dist0 = succ >= 0
    if end0 is None:
        end0 = torch.where(succ == -1, torch.arange(m, device=succ.device), -1)
    x = torch.stack([t.to(torch.int32) for t in (succ, dist0, mnmo, end0)], dim=1)
    x = rank_lists(x).to(torch.int64)
    return x[:, 0], x[:, 1], x[:, 2], x[:, 3]


def _rank_cutting_cycles(succ0, mnmo0, node, orient, state_of):
    """Rank, and where cycles remain cut each one where the reference's
    seed loop would (compression.rs:450-479) and rank again: at the exit of
    its min node in stored orientation, and at the mirror edge into the min
    node flipped.  ``state_of`` maps an item id to its orientation-0 state.

    Returns (dist, mnmo, end_id, extra_starts): the states a cut edge
    pointed into become chain starts.
    """
    m = succ0.shape[0]
    succ_f, dist, mnmo, end_id = _rank_all(succ0, mnmo0)
    is_cycle = succ_f >= 0
    extra_starts = torch.zeros(m, dtype=torch.bool, device=succ0.device)
    if bool(is_cycle.any()):
        mn_f = mnmo >> 1
        cut = is_cycle & (
            ((node == mn_f) & (orient == 0)) | (succ0 == state_of(mn_f) + 1)
        )
        _, dist, mnmo, end_id = _rank_all(torch.where(cut, -1, succ0), mnmo0)
        tgt = succ0[cut]
        extra_starts[tgt[(tgt >= 0) & (tgt < m)]] = True
    return dist, mnmo, end_id, extra_starts


def _emit_chains(n, node, orient, dist, mnmo, end_id, is_start, node_of_end) -> Chains:
    """Emission tail shared by the chain linkers: keep the traversal where
    the chain's min node is in stored orientation, number unitigs in
    increasing chain-min order (the reference's seed order,
    compression.rs:574), and label every item with (uid, position, flip).

    ``node``/``orient`` give each of the 2n states its item id and
    orientation; ``node_of_end`` maps an end-state index to its item id.
    Per-item results are indexed by state pair: entry i covers states 2i
    and 2i+1.
    """
    m = node.shape[0]
    dev = node.device
    mn, mo = mnmo >> 1, mnmo & 1
    emit = torch.nonzero(is_start & (mo == 0)).flatten()
    emit = emit[torch.argsort(mn[emit])]
    n_unitigs = emit.shape[0]
    c_end = end_id[emit]
    length_u = dist[emit] + 1

    # every state reads its unitig id and length through its chain's end
    ok = (c_end >= 0) & (c_end < m)
    tbl = torch.full((m, 2), -1, dtype=torch.int64, device=dev)
    tbl[c_end[ok]] = torch.stack([torch.arange(n_unitigs, device=dev)[ok], length_u[ok]], dim=1)
    g = gather_rows(tbl, end_id)
    uid_state = torch.where(end_id >= 0, g[:, 0], -1)
    pos_state = g[:, 1] - 1 - dist

    # each item has exactly one emitted state
    emit_pair = (uid_state >= 0).reshape(n, 2)
    pick0 = emit_pair[:, 0]

    def take(a):
        a2 = a.reshape(n, 2)
        return torch.where(pick0, a2[:, 0], a2[:, 1])

    return Chains(
        uid=torch.where(emit_pair.any(dim=1), take(uid_state), -1),
        pos=take(pos_state),
        flip=~pick0,
        n_unitigs=n_unitigs,
        length=length_u,
        first_item=node[emit],
        last_item=node_of_end(c_end.clamp(0, max(m - 1, 0))),
        first_flip=orient[emit],
        last_flip=c_end & 1,
    )


def link_chains(partner_l, partner_r, in_l, in_r, valid=None) -> Chains:
    """Label each item with (unitig id, position, orientation).

    Precondition: partner edges are mutual and entry-side consistent, as
    :func:`resolve_edges` leaves them; chain starts then follow from
    ``partner < 0`` alone.  ``valid`` ((n,) bool, optional) masks items out:
    they belong to no unitig (uid -1) and no partner may point at them (the
    censored nodes of ``graph.compress_graph``).
    """
    n = partner_l.shape[0]
    dev = partner_l.device
    node = torch.arange(n, device=dev).repeat_interleave(2)
    orient = torch.arange(2, device=dev).repeat(n)
    succ0 = _succ_states(partner_l, partner_r, in_l, in_r)
    live = None if valid is None else valid.repeat_interleave(2)
    if live is not None:
        succ0 = torch.where(live, succ0, -1)
    # packed (min node, orient): node ids are unique within a chain, so the
    # packed min is the min node with its orientation
    mnmo0 = (node << 1) | orient
    dist, mnmo, end_id, extra_starts = _rank_cutting_cycles(
        succ0, mnmo0, node, orient, lambda i: 2 * i
    )
    # a state has no predecessor iff its entry-side partner is absent:
    # (i, 0) is entered via stored L, (i, 1) via stored R
    no_pred = torch.stack([partner_l < 0, partner_r < 0], dim=1).reshape(2 * n)
    is_start = no_pred | extra_starts
    if live is None:
        return _emit_chains(n, node, orient, dist, mnmo, end_id, is_start,
                            node_of_end=lambda e: e >> 1)
    ch = _emit_chains(n, node, orient, dist, mnmo, end_id, is_start & live,
                      node_of_end=lambda e: e >> 1)
    return dataclasses.replace(ch, uid=torch.where(valid, ch.uid, -1))


def discovery_intervals(partner_l, partner_r, first_pos, valid=None):
    """Items in discovery order and their read-adjacent intervals (steps 1
    and 2 of :func:`link_chains_ordered`).

    Returns (orig, rank, rlp, rrp, bnd): ``orig[x]`` is the item of rank
    ``x`` (increasing ``first_pos``, ties by item id; items ``valid``
    masks out rank last), ``rank`` its inverse, ``rlp``/``rrp`` the ranks
    of rank ``x``'s left/right partners (-1: none), and ``bnd`` marks the
    first rank of each interval, a maximal run of ranks each a partner of
    the one before.
    """
    n = partner_l.shape[0]
    pos = torch.arange(n, device=partner_l.device)
    # the JAX package's key: valid items' first_pos clamped below the
    # invalid items' sentinel
    key = first_pos.to(torch.int64).clamp(0, 0x7FFFFFFE)
    if valid is not None:
        key = torch.where(valid, key, 0x7FFFFFFF)
    orig = torch.sort(key, stable=True).indices
    rank = torch.empty_like(orig)
    rank[orig] = pos
    plo, pro = partner_l[orig], partner_r[orig]
    rlp = torch.where(plo >= 0, rank[plo.clamp(min=0)], -1)
    rrp = torch.where(pro >= 0, rank[pro.clamp(min=0)], -1)
    join = (rlp == pos + 1) | (rrp == pos + 1)  # rank x continues into x + 1
    bnd = torch.ones(n, dtype=torch.bool, device=pos.device)
    bnd[1:] = ~join[:-1]
    return orig, rank, rlp, rrp, bnd


def link_chains_ordered(partner_l, partner_r, in_l, in_r, valid, first_pos, cap: int):
    """Chain linking by read-adjacency contraction: :func:`link_chains`'
    result, with list ranking on a graph of intervals.

    ``valid`` ((n,) bool, or None for all) masks items out as in
    :func:`link_chains`: they rank after every valid item, start no chain
    and get uid -1.

    ``first_pos`` is each item's first-occurrence observation index
    (``filter_kmers(data_reduce="obs_min")``).  In that order most chain
    edges join rank-adjacent items, so chains contract into intervals of
    consecutive ranks; each interval becomes two contracted nodes (its two
    traversals) weighted by its length, and only those are ranked.  A
    cycle among them falls back to ranking every state.  The result does
    not depend on ``first_pos``: any values only change how far the graph
    contracts.

    ``cap`` bounds the interval count.  Returns (chains, overflow):
    ``overflow`` is True when there are more than ``cap`` intervals, where
    the JAX package's chains are invalid and its callers fall back to
    :func:`link_chains`; here the chains then come from that fallback.
    Lanes are int64, so there is no limit on n below the carry's 2^31
    states.
    """
    n = partner_l.shape[0]
    dev = partner_l.device
    orig, rank, rlp, rrp, bnd = discovery_intervals(partner_l, partner_r, first_pos, valid)
    starts = torch.nonzero(bnd).flatten()  # interval first ranks, in order
    n_iv = starts.shape[0]
    # invalid items hold the last ranks; only valid intervals count
    n_valid = n if valid is None else int(valid.sum())
    if int((starts < n_valid).sum()) > cap:
        return link_chains(partner_l, partner_r, in_l, in_r, valid), True

    pos = torch.arange(n, device=dev)
    live = (pos < n_valid).repeat_interleave(2)
    is_end = torch.ones(n, dtype=torch.bool, device=dev)
    is_end[:-1] = bnd[1:]
    icid = torch.cumsum(bnd, 0) - 1  # interval id of each rank
    # orientation of the traversal that moves to higher ranks (state (x, 0)
    # exits stored R and is entered via stored L)
    ofwd = torch.where(
        rrp == pos + 1, 0,
        torch.where(rlp == pos + 1, 1,
                    torch.where(rlp == pos - 1, 0, torch.where(rrp == pos - 1, 1, 0))),
    )
    a_of = S.copy_first(pos, bnd)   # interval first rank, per rank
    b_of = S.copy_last(pos, is_end)  # interval last rank, per rank
    ca, cb = starts, b_of[starts]
    ca_of, cb_of = ofwd[ca], ofwd[cb]
    clen = cb - ca + 1
    # the chain-min aggregate (item << 1 | forward orientation) per interval
    cmn = S.segment_min((orig << 1) | ofwd, icid, n_iv)

    # sigma states: 2x + o is rank x in orientation o
    succ_sig = torch.where(live, _succ_states(rlp, rrp, in_l[orig], in_r[orig]), -1)
    node_sig = orig.repeat_interleave(2)
    orient_sig = torch.arange(2, device=dev).repeat(n)
    no_pred = torch.stack([rlp < 0, rrp < 0], dim=1).reshape(2 * n)

    def contracted(tsig):
        # target sigma state -> contracted node 2 * interval + traversal: it
        # has a predecessor, so it enters exactly one traversal, T+ iff it is
        # its interval's first rank in forward orientation
        t = tsig.clamp(min=0) >> 1
        tv = torch.where(bnd[t] & ((tsig.clamp(min=0) & 1) == ofwd[t]), 0, 1)
        return torch.where(tsig >= 0, 2 * icid[t] + tv, -1)

    # T+ exits at (b, ofwd_b), T- at (a, 1 - ofwd_a)
    exit_p, exit_m = 2 * cb + cb_of, 2 * ca + (1 - ca_of)
    cs_p, cs_m = contracted(succ_sig[exit_p]), contracted(succ_sig[exit_m])

    def pair(p, q):
        return torch.stack([p, q], dim=1).reshape(-1)

    csucc, cdist, cmnmo, cend = _rank_all(
        pair(cs_p, cs_m),
        pair(cmn, cmn ^ 1),
        pair(clen - 1 + (cs_p >= 0), clen - 1 + (cs_m >= 0)),
        pair(torch.where(cs_p == -1, exit_p, -1), torch.where(cs_m == -1, exit_m, -1)),
    )
    if bool((csucc >= 0).any()):
        # a cycle of intervals (rare): rank every sigma state
        dist, mnmo, end_id, extra_starts = _rank_cutting_cycles(
            succ_sig, (node_sig << 1) | orient_sig, node_sig, orient_sig,
            lambda i: 2 * rank[i.clamp(0, max(n - 1, 0))],
        )
    else:
        # expand: every rank reads its interval's results; the chain-min
        # aggregate is read at start states only, which are traversal entries
        d_p, d_m = cdist[0::2][icid], cdist[1::2][icid]
        e_p, e_m = cend[0::2][icid], cend[1::2][icid]
        q_p, q_m = pos - a_of, b_of - pos
        fwd0 = ofwd == 0
        dist = pair(torch.where(fwd0, d_p - q_p, d_m - q_m), torch.where(fwd0, d_m - q_m, d_p - q_p))
        end_id = pair(torch.where(fwd0, e_p, e_m), torch.where(fwd0, e_m, e_p))
        mnmo = torch.zeros(2 * n, dtype=torch.int64, device=dev)
        mnmo[2 * ca + ca_of] = cmnmo[0::2]
        mnmo[2 * cb + (1 - cb_of)] = cmnmo[1::2]
        extra_starts = torch.zeros(2 * n, dtype=torch.bool, device=dev)

    ch = _emit_chains(n, node_sig, orient_sig, dist, mnmo, end_id, (no_pred | extra_starts) & live,
                      node_of_end=lambda e: node_sig[e])
    # per-rank labels back to item order; an item in no unitig gets position
    # 0, as the JAX package's clamp gives it
    pos_r = torch.where(ch.uid >= 0, ch.pos, 0)
    return dataclasses.replace(ch, uid=ch.uid[rank], pos=pos_r[rank], flip=ch.flip[rank]), False


def unitig_end_exts(exts: torch.Tensor, chains: Chains) -> torch.Tensor:
    """Per-unitig Exts byte from the terminal kmers' stored exts: the
    walk-left side of the first item and the walk-right side of the last,
    complemented where flipped (compression.rs:513-517,534-538)."""
    e_first = exts[chains.first_item]
    e_last = exts[chains.last_item]
    left_nib = torch.where(
        chains.first_flip == 0,
        E.dir_bits(e_first, LEFT),
        E.complement_bits(E.dir_bits(e_first, RIGHT)) & 0x0F,
    )
    right_nib = torch.where(
        chains.last_flip == 0,
        E.dir_bits(e_last, RIGHT),
        E.complement_bits(E.dir_bits(e_last, LEFT)) & 0x0F,
    )
    return E.from_single_dirs(left_nib, right_nib)


def compress_kmer_table_device(spec: KmerSpec, stranded: bool, kmers: torch.Tensor,
                               exts: torch.Tensor, join_labels=None, first_pos=None,
                               order_cap=None):
    """Device compression of a sorted unique table: (chains, unitig exts,
    per-kmer contributed base).  compress_kmers_with_hash equivalent
    (compression.rs:588-594).

    ``join_labels``: see :func:`resolve_edges`.  With ``first_pos`` (each
    kmer's first-occurrence observation index,
    ``filter_kmers(data_reduce="obs_min")``'s ``data``) chain linking runs
    through :func:`link_chains_ordered`, with ``order_cap`` intervals at
    most (default ``max(2**14, n // 8)``), and the result gains a fourth
    element, ``overflow``.
    """
    edges = resolve_edges(spec, stranded, kmers, exts, join_labels)
    args = (edges["partner_l"], edges["partner_r"], edges["in_l"], edges["in_r"])
    if first_pos is None:
        return _with_ends(spec, kmers, exts, link_chains(*args))
    cap = order_cap or max(1 << 14, kmers.shape[0] // 8)
    chains, overflow = link_chains_ordered(*args, None, first_pos, cap)
    return _with_ends(spec, kmers, exts, chains) + (overflow,)


def _with_ends(spec: KmerSpec, kmers, exts, chains: Chains):
    """(chains, unitig exts, the base each kmer adds to its unitig: its
    oriented last base)."""
    contrib = torch.where(
        chains.flip, (~KM.first_base(spec, kmers)) & 3, KM.last_base(spec, kmers)
    )
    return chains, unitig_end_exts(exts, chains), contrib


def _finalize_compress(spec: KmerSpec, kmers, exts, cand_l, cand_r, in_l, in_r, join_l, join_r):
    """Second half of the rich path, after ``resolve_edges(...,
    return_candidates=True)``: keep the candidate edges whose join
    masks hold, enforce mutuality, link chains; (chains, unitig exts,
    contributed bases) as :func:`compress_kmer_table_device` gives them."""
    partners = {LEFT: torch.where(join_l, cand_l, -1), RIGHT: torch.where(join_r, cand_r, -1)}
    edges = _enforce_mutual(partners, {LEFT: in_l, RIGHT: in_r})
    chains = link_chains(edges["partner_l"], edges["partner_r"], edges["in_l"], edges["in_r"])
    return _with_ends(spec, kmers, exts, chains)


# ---------------------------------------------------------------------------
# the policy layer: how per-kmer data folds along unitigs
# ---------------------------------------------------------------------------


class CompressionSpec:
    """Pluggable unitig-merge policy (compression.rs:34-38).

    ``reduce`` folds per-item data along the unitig: a named associative op
    (``"sum_sat_u16"``, ``"sum"``, ``"max"``, ``"min"``, ``"first"``) or a
    closure ``reduce(path_data, item_data) -> data`` folded on the host in
    unitig path order.  ``join_labels``: None, or a callable mapping item
    data to an int label, or True for the data itself; two adjacent items
    merge only where their labels are equal (the reference's ``join_test``
    restricted to equivalence tests, as ScmapCompress uses it,
    compression.rs:84-98).
    """

    def __init__(self, reduce="sum_sat_u16", join_labels=None):
        self.reduce = reduce
        self.join_labels = join_labels

    def label_array(self, data: np.ndarray):
        """Per-item int32 labels for the equality join mask, or None."""
        if self.join_labels is None:
            return None
        if self.join_labels is True:
            return np.asarray(data, np.int32)
        return np.asarray([self.join_labels(int(d)) for d in np.asarray(data)], np.int32)


class SimpleCompress(CompressionSpec):
    """Closure or named-op reduce, unconditional join (compression.rs:40-65)."""

    def __init__(self, reduce):
        super().__init__(reduce=reduce, join_labels=None)


class ScmapCompress(CompressionSpec):
    """Join only equal data; the unitig keeps that data (compression.rs:68-98)."""

    def __init__(self):
        super().__init__(reduce="first", join_labels=True)


def _reduce_np(op: str, vals: np.ndarray, uid: np.ndarray, n_unitigs: int) -> np.ndarray:
    """A named reduction of ``vals`` by unitig id, in numpy (the JAX
    package's function): "first" writes every row, so the last live row in
    slot order wins."""
    if op == "sum_sat_u16":
        acc = np.zeros(n_unitigs, np.int64)
        np.add.at(acc, uid, vals.astype(np.int64))
        return np.minimum(acc, F.COUNT_MAX).astype(np.int32)
    if op == "sum":
        acc = np.zeros(n_unitigs, np.int64)
        np.add.at(acc, uid, vals.astype(np.int64))
        return acc.astype(np.int32)
    if op == "max":
        acc = np.full(n_unitigs, np.iinfo(np.int32).min, np.int32)
        np.maximum.at(acc, uid, vals.astype(np.int32))
        return acc
    if op == "min":
        acc = np.full(n_unitigs, np.iinfo(np.int32).max, np.int32)
        np.minimum.at(acc, uid, vals.astype(np.int32))
        return acc
    if op == "first":  # all-equal data (ScmapCompress)
        acc = np.zeros(n_unitigs, np.int32)
        acc[uid] = vals
        return acc
    raise ValueError(op)


def _fold_host(data_reduce, vals, uid, pos, n_unitigs) -> np.ndarray:
    """Each unitig's int ``vals`` folded by ``data_reduce`` on the host: a
    closure in unitig path order (:func:`_fold_closure`), a name by
    :func:`_reduce_np`.  ``uid``/``pos``: each value's unitig and position."""
    if callable(data_reduce):
        return _fold_closure(data_reduce, vals, uid, pos, n_unitigs)
    return _reduce_np(data_reduce, vals, uid, n_unitigs)


def _fold_closure(fn, vals, uid, pos, n_unitigs) -> np.ndarray:
    """Fold a reduce closure over int data in unitig path order, left to
    right (build_node's fold, compression.rs:510,531); 0 for a unitig with
    no item."""
    acc = _fold_objects(fn, [int(v) for v in vals], np.arange(len(vals)), uid, pos, n_unitigs)
    return np.asarray([0 if a is None else a for a in acc], np.int32)


def _fold_objects(fn, payloads, idxs, uid, pos, n_unitigs) -> list:
    """Fold payload objects per unitig in path order: row i's payload is
    ``payloads[idxs[i]]``.  The accumulator starts as the leftmost item's
    payload object itself, so ``fn`` must return a new object, not mutate
    its arguments; valid for associative and commutative reduces."""
    acc = [None] * n_unitigs
    seen = [False] * n_unitigs
    for i in np.lexsort((pos, uid)):
        u = int(uid[i])
        o = payloads[int(idxs[i])]
        acc[u] = fn(acc[u], o) if seen[u] else o
        seen[u] = True
    return acc


# ---------------------------------------------------------------------------
# unitig assembly: on the host, and on the card
# ---------------------------------------------------------------------------


def assemble_unitigs_flat(spec: KmerSpec, kmers: np.ndarray, uid, pos, flip, lengths,
                          first_item, first_flip, nutg: int, u_exts, contrib, data_np, *,
                          data_reduce="sum_sat_u16"):
    """Host: chain labels -> flat unitig buffers, with no per-unitig loop.
    ``flip`` is the JAX package's argument, unread there too: ``contrib``
    already holds each item's oriented base.

    Returns ``(seq_flat uint8, out_lengths int64, u_exts int32, data
    int32)``, the ``BaseGraph.add_flat`` input: ``data_np`` folded per
    unitig by ``data_reduce`` (:func:`_fold_host`).
    """
    live = uid >= 0
    data_red = _fold_host(data_reduce, data_np[live], uid[live], pos[live], nutg)
    out_lengths = (lengths[:nutg] + spec.k - 1).astype(np.int64)
    offsets = np.zeros(nutg + 1, np.int64)
    np.cumsum(out_lengths, out=offsets[1:])
    seq_flat = np.zeros(offsets[-1], np.uint8)
    # bases contributed by each kmer at pos >= 1
    tail = live & (pos > 0)
    seq_flat[offsets[uid[tail]] + spec.k - 1 + pos[tail]] = contrib[tail]
    # the first kmer of each unitig contributes all K bases, oriented
    if nutg:
        fk = KM.to_bases_batch_np(spec, kmers[first_item[:nutg]])  # (U, K)
        flip_u = first_flip[:nutg].astype(bool)
        fk[flip_u] = (3 - fk[flip_u, ::-1]) & 3
        idx = offsets[:nutg, None] + np.arange(spec.k)[None, :]
        seq_flat[idx.reshape(-1)] = fk.reshape(-1)
    return seq_flat, out_lengths, np.asarray(u_exts[:nutg], np.int32), data_red


def _nodes(seq_flat, out_lengths, u_exts, data) -> list:
    """Flat unitig buffers -> [(bases, exts, data)]; ``data`` is any
    sequence of per-unitig values."""
    offsets = np.zeros(len(out_lengths) + 1, np.int64)
    np.cumsum(out_lengths, out=offsets[1:])
    return [(seq_flat[offsets[u] : offsets[u + 1]], int(u_exts[u]), data[u])
            for u in range(len(out_lengths))]


def assemble_unitigs(spec: KmerSpec, kmers: np.ndarray, uid, pos, flip, lengths,
                     first_item, first_flip, nutg: int, u_exts, contrib, data_np, *,
                     data_reduce="sum_sat_u16"):
    """Host: chain labels -> unitig list [(bases, exts, data)]."""
    seq_flat, out_lengths, u_exts_t, data_red = assemble_unitigs_flat(
        spec, kmers, uid, pos, flip, lengths, first_item, first_flip, nutg,
        u_exts, contrib, data_np, data_reduce=data_reduce,
    )
    return _nodes(seq_flat, out_lengths, u_exts_t, data_red.tolist())


def assemble_chains(spec: KmerSpec, kmers: torch.Tensor, chains: Chains, u_exts, contrib,
                    counts) -> list:
    """Host: :func:`assemble_unitigs` on the output of
    :func:`compress_kmer_table_device` for a table's ``kmers`` and per-kmer
    data ``counts``, wherever they lie: every chain label crosses to the
    host."""
    cpu = lambda t: t.cpu().numpy()
    return assemble_unitigs(
        spec,
        KM.to_numpy(kmers),
        cpu(chains.uid),
        cpu(chains.pos),
        cpu(chains.flip),
        cpu(chains.length),
        cpu(chains.first_item),
        cpu(chains.first_flip),
        chains.n_unitigs,
        cpu(u_exts),
        cpu(contrib),
        cpu(counts),
    )


def assemble_unitigs_device(spec: KmerSpec, kmers: torch.Tensor, chains: Chains, contrib,
                            counts=None):
    """Unitig assembly on the chains' device: the flat layout of
    :func:`assemble_unitigs_flat`, so that only the bases (a byte each) and
    the per-unitig arrays need cross to the host.

    Unitig u holds ``out_lengths[u] = length[u] + K - 1`` bases from offset
    ``sum(out_lengths[:u])``: the first K - 1 of its first kmer read in its
    orientation, then every item's oriented last base in path order
    (build_node, compression.rs:483-541).  Every item lies in one unitig,
    so there are n + n_unitigs (K - 1) bases, known without reading the
    card.

    Returns (seq (n + n_unitigs (K - 1),) uint8, out_lengths (n_unitigs,)
    int64), and with ``counts`` also data (n_unitigs,) int32: each unitig's
    counts summed and saturated at 65535, and 65535 for a unitig of more
    than 65535 items whatever its counts (the JAX package's rule; with
    every count at least 1 the two agree).
    """
    k = spec.k
    n, nutg = kmers.shape[0], chains.n_unitigs
    dev = kmers.device
    out_len = chains.length + (k - 1)
    offsets = torch.cumsum(out_len, 0) - out_len
    seq = torch.empty(n + nutg * (k - 1), dtype=torch.uint8, device=dev)
    # each item's base lands at K - 1 + its position
    seq[gather_rows(offsets, chains.uid) + (k - 1) + chains.pos] = contrib.to(torch.uint8)
    # the K - 1 head bases of each unitig, from its first kmer as oriented
    w_in = torch.arange(k - 1, device=dev)
    flip = chains.first_flip.to(torch.bool)[:, None]
    fk = gather_rows(kmers, chains.first_item)[:, None, :].expand(-1, k - 1, -1)
    b = KM.get_base_dyn(spec, fk, torch.where(flip, k - 1 - w_in, w_in))
    seq[offsets[:, None] + w_in] = torch.where(flip, 3 - b, b).to(torch.uint8)
    if counts is None:
        return seq, out_len
    sums = torch.zeros(nutg, dtype=torch.int64, device=dev).index_add_(
        0, chains.uid, counts.to(torch.int64))
    data = torch.where(chains.length > F.COUNT_MAX, F.COUNT_MAX, sums.clamp(max=F.COUNT_MAX))
    return seq, out_len, data.to(torch.int32)


_PASS_WORDS = 1 << 16  # output words a pass of the device stitch (~70 MB of per-base work)


def _words_of(bases: torch.Tensor) -> torch.Tensor:
    """(16 m,) 2-bit codes -> (m,) words, first base highest, their uint32
    bits held as int32 (``dna.pack_bases``' words)."""
    shifts = 30 - 2 * torch.arange(16, dtype=torch.int64, device=bases.device)
    w = (bases.reshape(-1, 16).to(torch.int64) << shifts).sum(1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def pack_words(bases: torch.Tensor) -> torch.Tensor:
    """(L,) 2-bit codes -> (ceil(L / 16),) int32 words on their device,
    first base highest and the last word zero-padded: ``PackedSeqSet``'s
    words, bit for bit.  Packed ``_PASS_WORDS`` words at a time."""
    nw = -(-bases.shape[0] // 16)
    out = torch.empty(nw, dtype=torch.int32, device=bases.device)
    for lo in range(0, nw, _PASS_WORDS):
        hi = min(nw, lo + _PASS_WORDS)
        chunk = bases[16 * lo : 16 * hi]
        pad = torch.zeros(16 * (hi - lo) - chunk.shape[0], dtype=chunk.dtype, device=chunk.device)
        out[lo:hi] = _words_of(torch.cat([chunk, pad]))
    return out


def stitch_device(k: int, src: torch.Tensor, src_starts: torch.Tensor, src_lens: torch.Tensor,
                  node_ids: torch.Tensor, uid: torch.Tensor, pos: torch.Tensor,
                  flip: torch.Tensor, nutg: int):
    """:func:`stitch_flat` on the device of ``uid``: oriented node sequences
    concatenated per unitig, the K - 1 overlap dropped after position 0,
    output packed as 2-bit words.

    ``src`` holds the node sequences, as (L,) uint8 codes or as
    (ceil(L / 16),) int32 words (first base highest, as ``PackedSeqSet``
    stores them); node i's bases are ``src_lens[i]`` from ``src_starts[i]``
    (int64).  ``node_ids`` are the (m,) nodes taking part, with their chain
    labels ``uid`` (0..nutg - 1), ``pos`` and ``flip``.  Each output base is
    read from its source base by one gather and packed at once,
    ``_PASS_WORDS`` output words a pass, so no per-base array outlives its
    pass.  The total is read once, the only wait on the device.

    Returns (words (ceil(T / 16),) int32, out_lengths (nutg,) int64), on the
    device, T the bases written.  ``stitch_device.calls`` and
    ``stitch_device.bases`` count calls and bases written, over every call.
    """
    dev = uid.device
    _STITCH_COUNTS.calls += 1
    if nutg == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    if src.dtype == torch.uint8:
        src = pack_words(src)
    i64 = lambda t: t.to(device=dev, dtype=torch.int64)
    uid, pos = i64(uid), i64(pos)
    order = torch.argsort((uid << 32) | pos)  # path order; (uid, pos) pairs are unique
    nid = gather_rows(i64(node_ids), order)
    start, length = gather_rows(i64(src_starts), nid), gather_rows(i64(src_lens), nid)
    skip = torch.where(gather_rows(pos, order) > 0, k - 1, 0)
    step = 1 - 2 * gather_rows(i64(flip), order)  # +1 forward, -1 reverse-complemented
    contrib = length - skip
    ends = torch.cumsum(contrib, 0)  # each node's end in the output
    out_len = torch.zeros(nutg, dtype=torch.int64, device=dev).index_add_(
        0, gather_rows(uid, order), contrib)
    begin = ends - contrib
    first = torch.where(step < 0, start + length - 1 - skip, start + skip)  # its first source base
    total = int(ends[-1])
    _STITCH_COUNTS.bases += total
    nw = -(-total // 16)
    words = torch.empty(nw, dtype=torch.int32, device=dev)
    for lo in range(0, nw, _PASS_WORDS):
        hi = min(nw, lo + _PASS_WORDS)
        o = torch.arange(16 * lo, 16 * hi, device=dev)
        s = torch.searchsorted(ends, o, right=True)  # the node of each output base
        st = gather_rows(step, s)
        at = gather_rows(first, s) + st * (o - gather_rows(begin, s))
        b = (gather_rows(src, at >> 4) >> (30 - 2 * (at & 15))) & 3
        b = torch.where(st < 0, 3 - b, b)
        words[lo:hi] = _words_of(torch.where(o < total, b, 0))
    return words, out_len


stitch_device.calls = 0  # calls, over every call
stitch_device.bases = 0  # bases written, over every call
_STITCH_COUNTS = stitch_device  # where the counts go, should a caller rebind the module's name


def compress_kmers_flat_device(table, *, cap_bases: Optional[int] = None, device="cuda",
                               stats: Optional[dict] = None):
    """KmerTable -> (seq_flat uint8, out_lengths int64, u_exts int32, data
    int32) as numpy, compressed and assembled on ``device``
    (:func:`assemble_unitigs_device`): the default policy, each unitig's
    data the u16-saturating sum of its counts.  ``cap_bases`` sizes the JAX
    package's static output buffer; it is accepted and has no effect, as
    the output size is exact here.  ``stats``, a dict, receives
    ``compress.nodes_s``: the flat buffers' copies to the host
    (:class:`~tpu_debruijn_torch.stages.Stages`).
    """
    if len(table) == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    kmers = table.kmers.to(device)
    chains, u_exts, contrib = compress_kmer_table_device(
        table.spec, table.stranded, kmers, table.exts.to(device))
    seq, out_len, data = assemble_unitigs_device(table.spec, kmers, chains, contrib,
                                                 table.counts.to(device))
    cpu = lambda t, dt: t.cpu().numpy().astype(dt)
    with Stages(stats, device)("compress.nodes"):
        return cpu(seq, np.uint8), cpu(out_len, np.int64), cpu(u_exts, np.int32), cpu(data, np.int32)


def compress_kmers(table, *, data_reduce="sum_sat_u16", join_on_data: bool = False,
                   data_field: str = "counts", spec: Optional[CompressionSpec] = None,
                   device="cuda", stats: Optional[dict] = None):
    """KmerTable -> list of unitigs [(bases, exts, data)] on ``device``
    (compress_kmers_with_hash, compression.rs:588).

    The policy comes from ``spec`` (a :class:`CompressionSpec`) or from the
    shorthand knobs: ``data_reduce`` folds the per-kmer data of the table's
    ``data_field`` column, and ``join_on_data`` lets only equal data merge
    (ScmapCompress's join test, compression.rs:84-98).  Sequences assemble
    on ``device`` (:func:`assemble_unitigs_device`) under every policy; the
    data folds there too for "sum_sat_u16", and on the host from each
    item's unitig and position for any other reduce (:func:`_fold_data`).
    ``stats``, a dict, receives ``compress.nodes_s``: the tuple a unitig
    made on the host once the unitigs are there
    (:class:`~tpu_debruijn_torch.stages.Stages`).
    """
    if len(table) == 0:
        return []
    data = getattr(table, data_field)
    labels = data
    if spec is not None:
        data_reduce = spec.reduce
        label_np = spec.label_array(data.cpu().numpy())
        join_on_data = label_np is not None
        if join_on_data:
            labels = torch.from_numpy(label_np)
    kmers = table.kmers.to(device)
    chains, u_exts, contrib = compress_kmer_table_device(
        table.spec, table.stranded, kmers, table.exts.to(device),
        join_labels=labels.to(device=device, dtype=torch.int32) if join_on_data else None,
    )
    seq, out_len = assemble_unitigs_device(table.spec, kmers, chains, contrib)
    folded = _fold_data(data_reduce, data.to(device), chains)
    flat = seq.cpu().numpy(), out_len.cpu().numpy(), u_exts.cpu().numpy()
    with Stages(stats, device)("compress.nodes"):
        return _nodes(*flat, folded.tolist())


def _fold_data(data_reduce, data: torch.Tensor, chains: Chains) -> np.ndarray:
    """Each unitig's ``data`` folded by ``data_reduce`` as int32 numpy:
    "sum_sat_u16" on the chains' device (only the sums cross to the host),
    any other reduce on the host from each item's unitig and position
    (:func:`_fold_host`)."""
    if data_reduce == "sum_sat_u16":
        sums = torch.zeros(chains.n_unitigs, dtype=torch.int64, device=data.device)
        sums.index_add_(0, chains.uid, data.to(torch.int64))
        return sums.clamp(max=F.COUNT_MAX).to(torch.int32).cpu().numpy()
    return _fold_host(data_reduce, data.cpu().numpy(), chains.uid.cpu().numpy(),
                      chains.pos.cpu().numpy(), chains.n_unitigs)


def compress_kmers_rich(table, payloads, spec=None, *, reduce=None, join_test=None,
                        device="cuda") -> list:
    """Path compression with arbitrary payload objects (CompressionSpec<D>,
    compression.rs:34-38): ``payloads`` is a list aligned with the table's
    rows, ``reduce(acc, item) -> acc`` folds them along each unitig and
    ``join_test(d1, d2) -> bool`` decides each merge.  ``spec`` may be any
    object with ``.reduce`` and ``.join_test`` methods.

    The card resolves the candidate edges under every merge condition but
    the join test; the host evaluates ``join_test`` on those candidates
    only (the reference calls it once an extension, compression.rs:426);
    the masks go back to the card for mutuality and chain linking; the
    payloads fold per unitig in path order.  ``join_test`` must be
    symmetric and ``reduce`` associative and commutative, returning a new
    object.  Returns [(bases, exts, payload)].
    """
    n = len(table)
    if n == 0:
        return []
    if spec is not None:
        reduce, join_test = spec.reduce, spec.join_test
    if reduce is None:
        reduce = lambda a, b: a
    kmers, exts = table.kmers.to(device), table.exts.to(device)
    cand = resolve_edges(table.spec, table.stranded, kmers, exts, return_candidates=True)
    joins = []
    for key in ("partner_l", "partner_r"):
        jm = np.ones(n, bool)
        if join_test is not None:
            arr = cand[key].cpu().numpy()
            for i in np.nonzero(arr >= 0)[0]:
                jm[i] = bool(join_test(payloads[int(i)], payloads[int(arr[i])]))
        joins.append(torch.from_numpy(jm).to(device))
    chains, u_exts, contrib = _finalize_compress(
        table.spec, kmers, exts, cand["partner_l"], cand["partner_r"], cand["in_l"],
        cand["in_r"], *joins)
    seq, out_len = assemble_unitigs_device(table.spec, kmers, chains, contrib)
    uid, pos = chains.uid.cpu().numpy(), chains.pos.cpu().numpy()
    live = np.nonzero(uid >= 0)[0]
    objs = _fold_objects(reduce, payloads, live, uid[live], pos[live], chains.n_unitigs)
    return _nodes(seq.cpu().numpy(), out_len.cpu().numpy(), u_exts.cpu().numpy(), objs)


def _fold_pairs_device(pu: torch.Tensor, pl: torch.Tensor):
    """Per-unitig label-set union: the (unitig, label) pairs of the live
    rows (``pu >= 0``), sorted by unitig and then by label as a uint32, each
    once.  One sort of the pairs and their run starts, on their device;
    returns (uids int64, labels int32)."""
    live = torch.nonzero(pu >= 0).flatten()
    key = torch.stack([gather_rows(pu, live), gather_rows(pl, live).to(torch.int64) & KM.M32], dim=1)
    key = gather_rows(key, S.lex_argsort(key))
    key = gather_rows(key, torch.nonzero(S.run_starts(key)).flatten())
    return key[:, 0].contiguous(), key[:, 1].to(torch.int32)


def compress_kmers_color_sets(table, pair_label, split, *, join_on_sets: bool = False,
                              device="cuda", stats: Optional[dict] = None):
    """Fold label sets ("colors") through compression as arrays: no Python
    object a kmer, no Python call an edge.

    Row i's set is ``pair_label[split[i]:split[i + 1]]``
    (:func:`~tpu_debruijn_torch.filter.filter_kmers_set_arrays`; tensors or
    numpy arrays); a unitig's set is the sorted union of its kmers' sets
    (``SimpleCompress`` extending and deduplicating ``Vec<u8>`` colors,
    compression.rs:40-65).  With ``join_on_sets`` kmers merge only where
    their sets are equal (ScmapCompress, compression.rs:68-98), decided by
    eq-class ids as join labels.  Sequences assemble on ``device``.

    Returns (nodes, out_labels int32, out_split int64), as numpy: ``nodes``
    is [(bases, exts, data)], data the eq-class id with ``join_on_sets``
    and 0 without; unitig u's set is ``out_labels[out_split[u]:out_split[u + 1]]``.
    ``stats``, a dict, receives the seconds of three stages
    (:class:`~tpu_debruijn_torch.stages.Stages`): ``compress.eq_classes_s``
    (the eq-class ids, with ``join_on_sets``), ``compress.nodes_s`` (the
    tuple a unitig, as :func:`compress_kmers` has it) and
    ``compress.fold_sets_s`` (each unitig's set, to the host).
    """
    n = len(table)
    if n == 0:
        return [], np.zeros(0, np.int32), np.zeros(1, np.int64)
    stage = Stages(stats, device)
    pair_label = F.as_tensor(pair_label, torch.int32, device)
    split = F.as_tensor(split, torch.int64, device)
    labels = None
    if join_on_sets:
        with stage("compress.eq_classes"):
            labels = F.eq_class_ids(pair_label, split)[0]
    kmers = table.kmers.to(device)
    chains, u_exts, contrib = compress_kmer_table_device(
        table.spec, table.stranded, kmers, table.exts.to(device), join_labels=labels)
    seq, out_len = assemble_unitigs_device(table.spec, kmers, chains, contrib)
    node_data = (gather_rows(labels, chains.first_item).tolist() if join_on_sets
                 else [0] * chains.n_unitigs)
    flat = seq.cpu().numpy(), out_len.cpu().numpy(), u_exts.cpu().numpy()
    with stage("compress.nodes"):
        nodes = _nodes(*flat, node_data)
    with stage("compress.fold_sets"):
        slot_of_pair = torch.repeat_interleave(torch.arange(n, device=device), torch.diff(split))
        uids, out_labels = _fold_pairs_device(gather_rows(chains.uid, slot_of_pair), pair_label)
        out_split = torch.searchsorted(uids, torch.arange(chains.n_unitigs + 1, device=device))
        return nodes, out_labels.cpu().numpy(), out_split.cpu().numpy()


def infer_exts_device(spec: KmerSpec, stranded: bool, kmers: torch.Tensor) -> torch.Tensor:
    """Extension bytes from set membership alone (compress_kmers_no_exts,
    compression.rs:628-646): bit ``b + 4 d`` is set iff the neighbor by
    base b in direction d, canonical unless stranded, is a row of the
    sorted unique ``kmers``."""
    return F.neighbor_bits(spec, stranded, kmers, kmers)[0]


def compress_kmers_no_exts(k: int, kmers, data=None, *, stranded: bool = False,
                           data_reduce="sum_sat_u16", join_on_data: bool = False,
                           spec: Optional[CompressionSpec] = None, device="cuda") -> list:
    """A kmer set without extensions -> unitig list (compress_kmers_no_exts,
    compression.rs:619-659).

    ``kmers`` is an (n, W) uint32 limb array (or an int64 limb tensor), in
    any order; a duplicate keeps its first row's ``data`` (an optional
    aligned int payload).  On ``device`` the kmers are sorted and
    deduplicated, their extensions inferred (:func:`infer_exts_device`),
    and :func:`compress_kmers` runs with ``data_field="data"``.
    """
    kspec = KmerSpec(k)
    if not torch.is_tensor(kmers):
        kmers = np.asarray(kmers, np.uint32).astype(np.int64)
    kmers = F.as_tensor(kmers, torch.int64, device).reshape(-1, kspec.w)
    data = torch.zeros(kmers.shape[0]) if data is None else data
    data = F.as_tensor(data, torch.int32, device)
    # a stable sort keeps each run of duplicates in input order
    perm = S.lex_argsort(kmers)
    kmers, data = gather_rows(kmers, perm), gather_rows(data, perm)
    keep = torch.nonzero(S.run_starts(kmers)).flatten()
    kmers, data = gather_rows(kmers, keep), gather_rows(data, keep)
    n = kmers.shape[0]
    if n == 0:
        return []
    table = F.KmerTable(kspec, stranded, kmers, infer_exts_device(kspec, stranded, kmers),
                        torch.ones(n, dtype=torch.int32, device=device), data)
    return compress_kmers(table, data_reduce=data_reduce, join_on_data=join_on_data,
                          data_field="data", spec=spec, device=device)


def stitch_flat(k: int, src_flat: np.ndarray, src_starts: np.ndarray, src_lens: np.ndarray,
                node_ids: np.ndarray, uid: np.ndarray, pos: np.ndarray, flip: np.ndarray,
                nutg: int):
    """Concatenate oriented node sequences per unitig, dropping K - 1
    overlaps (build_node at node granularity, compression.rs:291-334), in
    numpy on the host: every output base is mapped to its source base in
    one gather.

    ``src_flat``/``src_starts``/``src_lens`` hold the node sequences;
    ``node_ids`` the (m,) nodes taking part, with their chain labels
    ``uid``/``pos``/``flip``; uid values are 0..nutg - 1.  Returns
    (out_flat uint8, out_lengths int64).
    """
    if nutg == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    order = np.lexsort((pos, uid))
    nid = node_ids[order]
    uid_s, pos_s = uid[order], pos[order]
    flip_s = flip[order].astype(bool)
    src_start_n = src_starts[nid].astype(np.int64)
    src_len_n = src_lens[nid].astype(np.int64)
    skip = np.where(pos_s > 0, k - 1, 0).astype(np.int64)
    contrib = src_len_n - skip
    # sorted by uid, so the output layout is the running sum
    cum_excl = np.zeros(len(contrib), np.int64)
    np.cumsum(contrib[:-1], out=cum_excl[1:])
    total = int(contrib.sum())
    out_lengths = np.bincount(uid_s, weights=contrib, minlength=nutg).astype(np.int64)
    rep = np.repeat(np.arange(len(nid)), contrib)  # the node of each output base
    within = np.arange(total, dtype=np.int64) - np.repeat(cum_excl, contrib)
    fwd = src_start_n[rep] + skip[rep] + within
    rev = src_start_n[rep] + src_len_n[rep] - 1 - skip[rep] - within
    flip_rep = flip_s[rep]
    vals = src_flat[np.where(flip_rep, rev, fwd)]
    return np.where(flip_rep, 3 - vals, vals).astype(np.uint8), out_lengths
