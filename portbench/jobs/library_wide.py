"""``library_wide``: the library kind's assembly at any k, held to the reference on multi-word codes.

A job is the library kind's, call for call and span for span:
``filter_kmers`` -> ``remove_censored_exts`` -> ``compress_kmers`` ->
``from_compress_output(...).finish()`` -> ``clean_tips`` (nodes shorter
than the configuration's ``tip_max_bases``) -> ``to_gfa``.  Compared, as
there: the table after ``min_obs``, the exts after the censor, the unitigs,
the cleaned graph and the GFA, but against ``reference_wide.py`` through
``compare_wide.py``, whose kmer codes are rows of words, so k may pass 31.

While a profiler records, the job passes ``stats=`` to ``filter_kmers``,
``compress_kmers`` and ``clean_tips`` where each takes it, so that the
untraced window makes none of their synchronizations.  Every job records in
``stats["search.wide_rows"]`` how far the program's
``searchsorted_limbs.wide_rows`` (query rows times rounds of the binary
search over more than two limbs) grew over the job; a program without that
counter records nothing, and ``k63.search_rows_M`` reads None.
"""

from __future__ import annotations

import inspect

from portbench import compare as CP
from portbench import compare_wide as CW
from portbench import job
from portbench import reference_wide as RW


def reference(reads, cfg: dict, **kw) -> dict:
    return RW.assemble(reads, cfg, censor=True, **kw)


def sizes(ref: dict) -> tuple:
    """(table kmers, unitigs, cleaned nodes)."""
    return (int(ref["table"]["codes"].shape[0]), ref["n_unitigs"], ref["n_cleaned"])


def wide_rows():
    """The program's count of the wide search's rows, or None without it."""
    from tpu_debruijn_torch import sorting

    return getattr(sorting.searchsorted_limbs, "wide_rows", None)


class Job(job.Job):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.items = [(r, 0, 0) for r in self.reads]

    def run(self, span, stats):
        TA, TCL, TC, TF, TG, TP = job.program()
        from tpu_debruijn_torch import stages

        k, dev = self.k, self.device
        traced = stages.profiling()

        def staged(fn) -> dict:
            return {"stats": stats} if traced and "stats" in inspect.signature(fn).parameters \
                else {}

        rows = wide_rows()
        with span("count"):
            table = TF.filter_kmers(self.items, k, stranded=False, min_obs=self.cfg["min_obs"],
                                    device=dev, **staged(TF.filter_kmers))
        raw_exts = table.exts  # the censor sets table.exts anew
        with span("censor"):
            TF.remove_censored_exts(table, device=dev)
        with span("compress"):
            nodes = TC.compress_kmers(table, device=dev, **staged(TC.compress_kmers))
        with span("graph_build"):
            graph = TG.from_compress_output(k, False, nodes).finish(device=dev)
        with span("clean_tips"):
            cleaned = TCL.clean_tips(graph, self.tip, device=dev, **staged(TCL.clean_tips))
        with span("gfa"):
            cleaned.to_gfa(self.gfa)
        if rows is not None:
            stats["search.wide_rows"] = wide_rows() - rows
        return {"table": table, "raw_exts": raw_exts, "nodes": nodes, "cleaned": cleaned,
                "sizes": (len(table), len(nodes), len(cleaned))}

    def summarize(self, out):
        t, k, dev = out["table"], self.k, self.device
        return {"codes": CW.limb_rows(t.kmers.to(dev), k), "counts": t.counts.to(dev),
                "raw_exts": out["raw_exts"].to(dev), "exts": t.exts.to(dev),
                "unitigs": CW.nodes_repr(out["nodes"], k, dev),
                "cleaned": CW.graph_repr(out["cleaned"], k, dev)}

    def check(self, got, ref):
        out = _table_checks(got["codes"], got["counts"], got["raw_exts"], got["exts"], ref)
        out["unitigs"] = CW.unitig_diff(got["unitigs"], ref["unitigs"])
        out["cleaned"] = CW.unitig_diff(got["cleaned"], ref["cleaned"])
        out["gfa"] = CW.gfa_diff(self.gfa, ref["cleaned"], ref["edges"], self.k, self.device)
        return out


def _table_checks(codes, counts, raw_exts, censored_exts, ref) -> dict:
    """``table`` (kmers, counts and exts after ``min_obs``) and ``censor``
    (the exts after the censor)."""
    table = CW.table_diff(codes, counts, raw_exts, ref["table"])
    cens = CW.table_diff(codes, counts, censored_exts,
                         {**ref["table"], "exts": ref["censored_exts"]})
    return {"table": table["kmers"] + table["counts"] + table["exts"],
            "censor": cens["kmers"] + cens["exts"]}


def control(cfg: dict, reads) -> dict:
    """The cell's numbers with the reference's exts taken from each kmer's
    first observation put in the program's place (ends of a GFA without
    their masks, as :func:`job.control_cleaned` has them)."""
    want = reference(reads, cfg)
    got = reference(reads, cfg, exts_reduce="first")
    t = got["table"]
    out = _table_checks(t["codes"], t["counts"], t["exts"], got["censored_exts"], want)
    out["unitigs"] = CW.unitig_diff({**got["unitigs"], "short": 0}, want["unitigs"])
    cleaned = {**got["cleaned"], "short": 0}
    out["cleaned"] = CW.unitig_diff(cleaned, want["cleaned"])
    out["gfa"] = (CW.unitig_diff({**cleaned, "ends": cleaned["ends"][:, :-1]}, want["cleaned"])
                  + CP.row_diff(got["edges"], want["edges"]))
    out["jobs"] = int(sizes(got) != sizes(want))
    return out
