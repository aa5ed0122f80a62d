"""``cli``: one assembly through the command line, ``assemble.run``.

Set-up writes the reads to a FASTQ file; each job runs ``assemble.run`` on
it with the traffic's ``argv`` (``{fastq}``, ``{gfa}`` and the
configuration's keys filled in) and its ``stats=`` stage seconds.  The
warm-up runs the same on a file of the first ``WARMUP_SHARE`` of the reads.
``assemble.run`` cleans the graph of the uncensored table.  Compared: the
cleaned graph and the GFA; the table is seen only as the size the command
prints, in the harness's ``jobs``.
"""

from __future__ import annotations

import contextlib
import io
import os
import re

from portbench import compare as CP
from portbench import generate, job
from portbench import reference as R

WARMUP_SHARE = 1 / 16  # of the reads, in the warm-up file


def reference(reads, cfg: dict, **kw) -> dict:
    return R.assemble(reads, cfg, censor=False, **kw)


def sizes(ref: dict) -> tuple:
    """(table kmers, cleaned nodes)."""
    return (int(ref["table"]["codes"].shape[0]), ref["n_cleaned"])


class Job(job.Job):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fastq = os.path.join(self.tmp, "reads.fq")
        generate.write_fastq(self.fastq, self.reads)

    def argv(self, fastq: str) -> list:
        keys = {**{k: v for k, v in self.cfg.items() if not isinstance(v, (dict, list))},
                "fastq": fastq, "gfa": self.gfa}
        return [a.format(**keys) for a in self.traffic["argv"]] + ["--device", str(self.device)]

    def warmup(self, span) -> None:
        """The job on a file of the first ``WARMUP_SHARE`` of the reads: it
        builds and loads what every job uses."""
        n = max(1, int(len(self.reads) * WARMUP_SHARE))
        path = os.path.join(self.tmp, "warmup.fq")
        generate.write_fastq(path, self.reads[:n])
        self._run(path, span, {})
        os.remove(path)

    def run(self, span, stats):
        return self._run(self.fastq, span, stats)

    def _run(self, fastq, span, stats):
        TA = job.program()[0]
        err = io.StringIO()
        with span("assemble.run"), contextlib.redirect_stderr(err):
            graph = TA.run(self.argv(fastq), stats=stats)
        said = err.getvalue()
        m = re.search(r"^(\d+) filtered kmers$", said, re.M)
        return {"cleaned": graph,
                "sizes": (int(m.group(1)) if m else -1, len(graph) if graph is not None else -1)}

    def summarize(self, out):
        return {"cleaned": CP.graph_repr(out["cleaned"], self.k, self.device)}

    def check(self, got, ref):
        return self.cleaned_checks(got, ref)


def control(cfg: dict, reads) -> dict:
    want = reference(reads, cfg)
    got = reference(reads, cfg, exts_reduce="first")
    return {**job.control_cleaned(got, want), "jobs": int(sizes(got) != sizes(want))}
