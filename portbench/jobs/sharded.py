"""``sharded``: one assembly the memory-bounded way on the reads in memory.

``parallel.assemble_sharded`` over the configuration's ``msp.shards``
logical shards of the device, minimizers of ``msp.p`` bases (with its
``stats=`` stage seconds) -> ``clean_tips`` -> ``to_gfa``.  Compared: the
unitigs (after the censor, as the one-batch assembly makes them), the
cleaned graph and the GFA.
"""

from __future__ import annotations

from portbench import compare as CP
from portbench import job
from portbench import reference as R


def reference(reads, cfg: dict, **kw) -> dict:
    return R.assemble(reads, cfg, censor=True, **kw)


def sizes(ref: dict) -> tuple:
    """(unitigs, cleaned nodes)."""
    return (ref["n_unitigs"], ref["n_cleaned"])


class Job(job.Job):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rows = list(self.reads)

    def run(self, span, stats):
        TA, TCL, TC, TF, TG, TP = job.program()
        msp, dev = self.cfg["msp"], self.device
        with span("assemble_sharded"):
            graph = TP.assemble_sharded(self.rows, self.k, msp["p"], stranded=False,
                                        min_obs=self.cfg["min_obs"],
                                        mesh=TP.make_mesh(msp["shards"], device=dev),
                                        device=dev, stats=stats)
        exts = graph.exts.copy()  # clean_tips sets the exts of the graph it cleans
        with span("clean_tips"):
            cleaned = TCL.clean_tips(graph, self.tip, device=dev)
        with span("gfa"):
            cleaned.to_gfa(self.gfa)
        return {"graph": graph, "exts": exts, "cleaned": cleaned,
                "sizes": (len(graph), len(cleaned))}

    def summarize(self, out):
        seqs = out["graph"].base.sequences
        return {"unitigs": CP.seq_repr(seqs._flat(), seqs.start, seqs.length, out["exts"], self.k,
                                       self.device),
                "cleaned": CP.graph_repr(out["cleaned"], self.k, self.device)}

    def check(self, got, ref):
        return {"unitigs": CP.unitig_diff(got["unitigs"], ref["unitigs"]),
                **self.cleaned_checks(got, ref)}


def control(cfg: dict, reads) -> dict:
    want = reference(reads, cfg)
    got = reference(reads, cfg, exts_reduce="first")
    out = {"unitigs": CP.unitig_diff({**got["unitigs"], "short": 0}, want["unitigs"])}
    out.update(job.control_cleaned(got, want))
    out["jobs"] = int(sizes(got) != sizes(want))
    return out
