"""``colored``: one colored assembly of labelled strains, on the reads in memory.

Set-up derives the labelled reads from the cell's read set
(:mod:`portbench.strains`).  A job: ``filter_kmers_set_arrays`` (each kmer's
label set; ``min_obs`` on its total) -> ``remove_censored_exts`` ->
``compress_kmers_color_sets(join_on_sets=True)`` (kmers join only across
equal sets; each unitig's data is its eq-class id, and its set comes back
beside it) -> ``from_compress_output(...).finish()`` -> ``clean_tips`` under
``ScmapCompress`` (nodes re-join only where their eq-class ids are equal)
-> ``to_gfa_with_tags``, each S line tagged ``CS:Z:`` with its node's set,
read from the eq-class id through the map that the unitigs give.
Compared (:mod:`portbench.reference_colored`): the table after ``min_obs``
(kmers, counts, exts), each kmer's set, the exts after the censor, the
unitigs, each unitig's set, the cleaned graph with its nodes' sets, and the
GFA with its tags.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import compare as CP
from portbench import job
from portbench import reference as R
from portbench import reference_colored as RC
from portbench import strains

_I64 = torch.int64
TAG = "CS:Z:"
LIBRARY = job.load("library")  # its table and censor checks


def reference(reads, cfg: dict, **kw) -> dict:
    """The reference of the labelled reads derived from ``reads``; ``kw``:
    ``sets_reduce`` (the control's switch)."""
    sreads, labels = strains.labelled_reads(cfg, reads, reads.device)
    del reads
    return RC.assemble(sreads, labels, cfg, **kw)


def sizes(ref: dict) -> tuple:
    """(table kmers, (kmer, label) pairs, unitigs, cleaned nodes)."""
    return (int(ref["table"]["codes"].shape[0]), ref["n_pairs"], ref["n_unitigs"],
            ref["n_cleaned"])


def masks(labels, split) -> torch.Tensor:
    """Each slot's labels ``labels[split[i]:split[i + 1]]`` (distinct, 0 to
    62) as a bit mask."""
    labels, split = torch.as_tensor(labels).to(_I64), torch.as_tensor(split).to(_I64)
    slot = torch.repeat_interleave(torch.arange(split.shape[0] - 1, device=split.device),
                                   torch.diff(split))
    return torch.zeros(split.shape[0] - 1, dtype=_I64, device=split.device).index_add_(
        0, slot, torch.ones((), dtype=_I64, device=split.device) << labels)


def kmer_set_rows(flat, starts, lengths, node_masks, k: int, device) -> torch.Tensor:
    """One row a kmer of the nodes: (its canonical code, its node's mask)."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(device)
    node, _, fwd, _ = CP.node_kmers(t(flat, torch.uint8), t(starts, _I64), t(lengths, _I64), k)
    canon = torch.minimum(fwd, R.rc_codes(fwd, k))
    return torch.stack([canon, t(node_masks, _I64)[node]], 1)


def tag_masks(path: str) -> np.ndarray:
    """Each S line's ``CS:Z:`` set as a mask (-1 where it has none)."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            p = line.rstrip(b"\n").split(b"\t")
            if p[0] != b"S":
                continue
            tags = [x[len(TAG):] for x in p[3:] if x.startswith(TAG.encode())]
            out.append(sum(1 << int(x) for x in tags[0].split(b",") if x) if len(tags) == 1
                       else -1)
    return np.array(out, np.int64)


class Job(job.Job):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        sreads, labels = strains.labelled_reads(self.cfg, self.reads, self.device)
        self.sreads, self.labels = sreads.cpu().numpy(), labels.cpu().numpy()
        del sreads, labels
        self.items = [(r, 0, lab) for r, lab in zip(self.sreads, self.labels.tolist())]

    def run(self, span, stats):
        TA, TCL, TC, TF, TG, TP = job.program()
        k, dev = self.k, self.device
        with span("count"):
            table, pair_label, split = TF.filter_kmers_set_arrays(
                self.items, k, stranded=False, min_obs=self.cfg["min_obs"], device=dev,
                stats=stats)
        raw_exts = table.exts  # the censor sets table.exts anew
        with span("censor"):
            TF.remove_censored_exts(table, device=dev)
        with span("compress"):
            nodes, out_labels, out_split = TC.compress_kmers_color_sets(
                table, pair_label, split, join_on_sets=True, device=dev, stats=stats)
        with span("graph_build"):
            graph = TG.from_compress_output(k, False, nodes).finish(device=dev)
        with span("clean_tips"):
            cleaned = TCL.clean_tips(graph, self.tip, spec=TC.ScmapCompress(), device=dev,
                                     stats=stats)
        with span("gfa"):
            sets = class_sets(nodes, out_labels, out_split)
            # a node whose data is no eq-class id gets an empty set, which the check counts
            cleaned.to_gfa_with_tags(self.gfa, lambda node: TAG + sets.get(node.data(), ""))
        return {"table": table, "raw_exts": raw_exts, "pair_label": pair_label, "split": split,
                "nodes": nodes, "out_labels": out_labels, "out_split": out_split,
                "cleaned": cleaned,
                "sizes": (len(table), int(pair_label.shape[0]), len(nodes), len(cleaned))}

    def summarize(self, out):
        t, k, dev = out["table"], self.k, self.device
        codes = CP.limb_codes(t.kmers.to(dev))
        nodes = out["nodes"]
        lengths = np.array([len(s) for s, _, _ in nodes], np.int64)
        flat = np.concatenate([np.asarray(s, np.uint8) for s, _, _ in nodes])
        node_masks = masks(torch.from_numpy(out["out_labels"]), torch.from_numpy(out["out_split"]))
        seqs = out["cleaned"].base.sequences
        cleaned_masks = class_masks(nodes, node_masks, out["cleaned"].data)
        return {"codes": codes, "counts": t.counts.to(dev), "raw_exts": out["raw_exts"].to(dev),
                "exts": t.exts.to(dev),
                "sets": torch.stack([codes, masks(out["pair_label"], out["split"]).to(dev)], 1),
                "unitigs": CP.nodes_repr(nodes, k, dev),
                "unitig_sets": kmer_set_rows(flat, np.cumsum(lengths) - lengths, lengths,
                                             node_masks, k, dev),
                "cleaned": CP.graph_repr(out["cleaned"], k, dev),
                "cleaned_sets": kmer_set_rows(seqs._flat(), seqs.start, seqs.length,
                                              cleaned_masks, k, dev)}

    def check(self, got, ref):
        cleaned = self.cleaned_checks(got, ref)
        return {**table_checks(got["codes"], got["counts"], got["raw_exts"], got["exts"],
                               got["sets"], ref),
                "unitigs": CP.unitig_diff(got["unitigs"], ref["unitigs"]),
                "unitig_sets": CP.row_diff(got["unitig_sets"], ref["unitig_sets"]),
                "cleaned": cleaned["cleaned"] + CP.row_diff(got["cleaned_sets"],
                                                            ref["cleaned_sets"]),
                "gfa": cleaned["gfa"] + self.tag_diff(ref)}

    def tag_diff(self, ref) -> int:
        """The GFA's tags against the cleaned unitigs' sets: rows (kmer, set)
        one side lacks, and S lines without one ``CS:Z:`` tag."""
        (_, flat, lengths), _, _ = CP.parse_gfa(self.gfa)
        tags = tag_masks(self.gfa)
        if tags.shape[0] != lengths.shape[0]:
            return max(tags.shape[0], lengths.shape[0])
        rows = kmer_set_rows(np.where(flat == 255, 0, flat), np.cumsum(lengths) - lengths,
                             lengths, tags, self.k, self.device)
        return CP.row_diff(rows, ref["cleaned_sets"]) + int((tags < 0).sum())


def table_checks(codes, counts, raw_exts, censored_exts, sets, ref) -> dict:
    """The library kind's ``table`` and ``censor``, and ``sets``: rows of a
    kmer and its set's mask that one side lacks."""
    want = torch.stack([ref["table"]["codes"], ref["table"]["sets"]], 1)
    return {**LIBRARY._table_checks(codes, counts, raw_exts, censored_exts, ref),
            "sets": CP.row_diff(sets, want)}


def class_masks(nodes, node_masks, data) -> torch.Tensor:
    """The set mask of each eq-class id in ``data`` (on the host), from the
    unitigs that carry each id; -1 for data that is no unitig's id."""
    ids = torch.tensor([d for _, _, d in nodes], dtype=_I64)
    data = torch.as_tensor(np.asarray(data, np.int64))
    n = int(torch.cat([ids, data, ids.new_zeros(1)]).max()) + 1
    table = torch.full((n,), -1, dtype=_I64)
    table[ids] = node_masks.cpu()
    return table[data.clamp(min=0)].where(data >= 0, -1)


def class_sets(nodes, out_labels, out_split) -> dict:
    """Eq-class id -> its set as the tag's text ("0,1,3"), from the first
    unitig that carries each id."""
    ids = np.array([d for _, _, d in nodes], np.int64)
    _, first = np.unique(ids, return_index=True)
    return {int(ids[u]): ",".join(map(str, out_labels[out_split[u]:out_split[u + 1]].tolist()))
            for u in first}


def control(cfg: dict, reads) -> dict:
    """The reference with each kmer's set taken from its first observation's
    label alone, in the program's place."""
    want = reference(reads, cfg)
    got = reference(reads, cfg, sets_reduce="first")
    t = got["table"]
    cleaned = job.control_cleaned(got, want)
    cleaned_sets = CP.row_diff(got["cleaned_sets"], want["cleaned_sets"])
    return {**table_checks(t["codes"], t["counts"], t["exts"], got["censored_exts"],
                           torch.stack([t["codes"], t["sets"]], 1), want),
            "unitigs": CP.unitig_diff({**got["unitigs"], "short": 0}, want["unitigs"]),
            "unitig_sets": CP.row_diff(got["unitig_sets"], want["unitig_sets"]),
            "cleaned": cleaned["cleaned"] + cleaned_sets,
            "gfa": cleaned["gfa"] + cleaned_sets,
            "jobs": int(sizes(got) != sizes(want))}
