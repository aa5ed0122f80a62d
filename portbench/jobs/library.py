"""``library``: one assembly through the library on the reads in memory.

``filter_kmers`` -> ``remove_censored_exts`` -> ``compress_kmers`` ->
``from_compress_output(...).finish()`` -> ``clean_tips`` (nodes shorter
than the configuration's ``tip_max_bases``) -> ``to_gfa``.  Compared: the
table after ``min_obs`` (kmers, counts, exts), the exts after the censor,
the unitigs, the cleaned graph and the GFA.
"""

from __future__ import annotations

from portbench import compare as CP
from portbench import job
from portbench import reference as R


def reference(reads, cfg: dict, **kw) -> dict:
    return R.assemble(reads, cfg, censor=True, **kw)


def sizes(ref: dict) -> tuple:
    """(table kmers, unitigs, cleaned nodes)."""
    return (int(ref["table"]["codes"].shape[0]), ref["n_unitigs"], ref["n_cleaned"])


class Job(job.Job):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.items = [(r, 0, 0) for r in self.reads]

    def run(self, span, stats):
        TA, TCL, TC, TF, TG, TP = job.program()
        k, dev = self.k, self.device
        with span("count"):
            table = TF.filter_kmers(self.items, k, stranded=False, min_obs=self.cfg["min_obs"],
                                    device=dev)
        raw_exts = table.exts  # the censor sets table.exts anew
        with span("censor"):
            TF.remove_censored_exts(table, device=dev)
        with span("compress"):
            nodes = TC.compress_kmers(table, device=dev)
        with span("graph_build"):
            graph = TG.from_compress_output(k, False, nodes).finish(device=dev)
        with span("clean_tips"):
            cleaned = TCL.clean_tips(graph, self.tip, device=dev)
        with span("gfa"):
            cleaned.to_gfa(self.gfa)
        return {"table": table, "raw_exts": raw_exts, "nodes": nodes, "cleaned": cleaned,
                "sizes": (len(table), len(nodes), len(cleaned))}

    def summarize(self, out):
        t, k, dev = out["table"], self.k, self.device
        return {"codes": CP.limb_codes(t.kmers.to(dev)), "counts": t.counts.to(dev),
                "raw_exts": out["raw_exts"].to(dev), "exts": t.exts.to(dev),
                "unitigs": CP.nodes_repr(out["nodes"], k, dev),
                "cleaned": CP.graph_repr(out["cleaned"], k, dev)}

    def check(self, got, ref):
        out = _table_checks(got["codes"], got["counts"], got["raw_exts"], got["exts"], ref)
        out["unitigs"] = CP.unitig_diff(got["unitigs"], ref["unitigs"])
        out.update(self.cleaned_checks(got, ref))
        return out


def _table_checks(codes, counts, raw_exts, censored_exts, ref) -> dict:
    """``table`` (kmers, counts and exts after ``min_obs``) and ``censor``
    (the exts after the censor)."""
    table = CP.table_diff(codes, counts, raw_exts, ref["table"])
    cens = CP.table_diff(codes, counts, censored_exts,
                         {**ref["table"], "exts": ref["censored_exts"]})
    return {"table": table["kmers"] + table["counts"] + table["exts"],
            "censor": cens["kmers"] + cens["exts"]}


def control(cfg: dict, reads) -> dict:
    want = reference(reads, cfg)
    got = reference(reads, cfg, exts_reduce="first")
    t = got["table"]
    out = _table_checks(t["codes"], t["counts"], t["exts"], got["censored_exts"], want)
    out["unitigs"] = CP.unitig_diff({**got["unitigs"], "short": 0}, want["unitigs"])
    out.update(job.control_cleaned(got, want))
    out["jobs"] = int(sizes(got) != sizes(want))
    return out
