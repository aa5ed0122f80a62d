"""Graph simplification: tip removal (counterpart of ``tpu_debruijn/clean.py``).

rust-debruijn's clean_graph.rs: a node is a tip when one side has no
extension, the other at most one, and a user predicate holds (typically
``len < 2K``); tips are censored and the graph re-compressed
(clean_graph.rs:30-51 + compression.rs:291).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from tpu_debruijn_torch import exts as E
from tpu_debruijn_torch.compress import CompressionSpec
from tpu_debruijn_torch.graph import DebruijnGraph, Node, compress_graph
from tpu_debruijn_torch.stages import Stages


class CleanGraph:
    """clean_graph.rs:9-51."""

    def __init__(self, tip_predicate: Callable[[Node], bool]):
        self.tip_predicate = tip_predicate

    def test_tip(self, graph: DebruijnGraph, node_id: int) -> Optional[int]:
        exts = int(graph.exts[node_id])
        nl, nr = E.num_ext_dir(exts, E.LEFT), E.num_ext_dir(exts, E.RIGHT)
        if ((nl == 0 and nr <= 1) or (nr == 0 and nl <= 1)) and self.tip_predicate(
                graph.get_node(node_id)):
            return node_id
        return None

    def find_bad_nodes(self, graph: DebruijnGraph) -> List[int]:
        """The tips, in node order.  The extension test runs over every node
        at once; the predicate is called only on the nodes that pass it."""
        nl, nr = E.num_ext_dir(graph.exts, E.LEFT), E.num_ext_dir(graph.exts, E.RIGHT)
        cand = np.nonzero(((nl == 0) & (nr <= 1)) | ((nr == 0) & (nl <= 1)))[0]
        return [int(i) for i in cand if self.tip_predicate(graph.get_node(int(i)))]


def clean_tips(graph: DebruijnGraph, tip_predicate: Callable[[Node], bool], *,
               data_reduce="sum_sat_u16", spec: Optional[CompressionSpec] = None,
               device="cuda", stats: Optional[dict] = None) -> DebruijnGraph:
    """Find the tips, censor them and re-compress on ``device``, under the
    merge policy ``spec`` where given (``ScmapCompress()`` re-joins only
    nodes of equal data), else folding the data by ``data_reduce``
    (:func:`~tpu_debruijn_torch.graph.compress_graph`).  ``stats``, a dict,
    receives ``clean.compress_graph_s``, the re-compression
    (:class:`~tpu_debruijn_torch.stages.Stages`); the rest of the call
    finds the tips."""
    bad = CleanGraph(tip_predicate).find_bad_nodes(graph)
    with Stages(stats, device)("clean.compress_graph"):
        return compress_graph(graph, censor_nodes=bad, data_reduce=data_reduce, spec=spec,
                              device=device)
