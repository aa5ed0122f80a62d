"""What the kinds of job share.  A kind is a file ``jobs/<entry>.py``, found
by the ``entry`` of a traffic mix (:func:`load`), like the metric readers.

Each job starts again from the same reads, runs one whole assembly through
the program's public entry points, and keeps what it produced.  A kind's
file defines:

- ``Job(cfg, traffic, reads, tmp, device)``, a subclass of :class:`Job`:
  ``warmup(span)``, ``run(span, stats)`` (its outputs, with ``sizes``),
  ``summarize(out)`` (what the comparison needs, before the program's state
  is freed) and ``check(got, ref)`` (each number compared, 0 when correct);
- ``reference(reads, cfg, **kw)``: the plain reference of what a job makes,
  from the reads alone (``kw``: the control's switch, ``exts_reduce``);
- ``sizes(ref)``: what every job's ``sizes`` must be, from the reference;
- ``control(cfg, reads)``: the cell's numbers for the control, the
  reference with a kmer's exts taken from its first observation put in the
  program's place (:mod:`portbench.control`).

A kind with a reference of its own keeps it in its file, or in a file of
its own beside it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import compare as CP
from portbench.readers import load_file


def load(entry: str):
    """The module ``jobs/<entry>.py``."""
    return load_file("jobs", entry)


def program():
    """The program's modules a job calls: (assemble, clean, compress,
    filter, graph, parallel)."""
    import tpu_debruijn_torch.assemble as TA
    from tpu_debruijn_torch import clean as TCL
    from tpu_debruijn_torch import compress as TC
    from tpu_debruijn_torch import filter as TF
    from tpu_debruijn_torch import graph as TG
    from tpu_debruijn_torch import parallel as TP

    return TA, TCL, TC, TF, TG, TP


class Job:
    """One kind of job on one read set (``reads``: (n, L) uint8 numpy)."""

    def __init__(self, cfg: dict, traffic: dict, reads: np.ndarray, tmp: str, device):
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.k = cfg["k"]
        self.reads = reads
        self.gfa = os.path.join(tmp, "out.gfa")
        self.tmp = tmp

    def tip(self, node) -> bool:
        return node.len() < self.cfg["tip_max_bases"]

    def warmup(self, span) -> None:
        self.run(span, {})

    def run(self, span, stats: dict) -> dict:
        raise NotImplementedError

    def summarize(self, out: dict) -> dict:
        raise NotImplementedError

    def check(self, got: dict, ref: dict) -> dict:
        raise NotImplementedError

    def cleaned_checks(self, got: dict, ref: dict) -> dict:
        """``cleaned`` (the graph after clean_tips) and ``gfa`` (the file the
        job wrote) against the reference."""
        return {"cleaned": CP.unitig_diff(got["cleaned"], ref["cleaned"]),
                "gfa": CP.gfa_diff(self.gfa, ref["cleaned"], ref["edges"], self.k, self.device)}


def control_cleaned(got: dict, want: dict) -> dict:
    """``cleaned`` and ``gfa`` of a control: its cleaned unitigs, and as a
    GFA holds them (ends without masks) with its links."""
    bare = {**got["cleaned"], "ends": got["cleaned"]["ends"][:, :1], "short": 0}
    return {"cleaned": CP.unitig_diff({**got["cleaned"], "short": 0}, want["cleaned"]),
            "gfa": CP.unitig_diff(bare, want["cleaned"]) + CP.row_diff(got["edges"], want["edges"])}

