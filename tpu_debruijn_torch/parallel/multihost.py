"""Several processes: the MSP-sharded assembly over a ``torch.distributed``
group, one device a process.

Counterpart of ``tpu_debruijn/parallel/multihost.py``.  Every process runs
the same program on its own reads (each reads its own files,
:func:`local_read_slice`) and owns a contiguous block of the global mesh's
shards (:func:`global_mesh`).  The exchange is an ``all_to_all_single`` and
the stitch's gathers are ``all_gather``s (``parallel.shard``), and every
process returns the same graph, node for node that of one process on the
union of the reads.  NCCL joins cards; gloo joins CPU processes, or
processes that share one card.

The JAX package's static-shape agreement has no counterpart: no padding
of every process's reads to one shape, no exchange capacity from a
histogram and no overflow retry (``cap_per_dest`` is accepted and unused),
and no resharding to replicate outputs (only the shards' unitig ends and
unitigs cross processes).
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from tpu_debruijn_torch.parallel.mesh import LogicalMesh, global_mesh
from tpu_debruijn_torch.parallel.shard import assemble_sharded

__all__ = ["assemble_multihost", "assemble_multiprocess", "global_mesh", "initialize",
           "local_read_slice"]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: Optional[str] = None,
               timeout: float = 600.0) -> None:
    """Join the default process group (no-op for one process or fewer).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or an
    ``init_method`` URL such as ``file:///path``; None reads torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).  ``backend`` None means
    NCCL (one card a process); pass "gloo" for CPU processes or processes
    that share one card.  A collective that waits ``timeout`` seconds for a
    process raises."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(backend or "nccl", init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def local_read_slice(paths: Sequence[str]) -> List[str]:
    """This process's input files: round-robin by rank over the world;
    every file without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return list(paths)
    rank, world = dist.get_rank(), dist.get_world_size()
    return [p for i, p in enumerate(paths) if i % world == rank]


def assemble_multiprocess(
    local_reads: Sequence[np.ndarray],
    k: int,
    p: int,
    *,
    stranded: bool = False,
    min_obs: int = 1,
    mesh: Optional[LogicalMesh] = None,
    cap_per_dest: Optional[int] = None,
    data_reduce_compress="sum_sat_u16",
    device="cuda",
    stats: Optional[dict] = None,
):
    """The sharded assembly over every process of the group.

    Every process calls this with its OWN reads (a process may have none);
    the union is assembled over ``mesh`` (default ``global_mesh(8,
    device)``) and every process returns the identical ``DebruijnGraph``,
    its links on ``device``.  Each process scans its reads, trades
    intervals by ``all_to_all_single``, counts, compresses and assembles
    its own shards on ``device``, and ``all_gather``s only their unitig
    ends and unitigs; then each runs the stitch and the data fold
    (``parallel.assemble_sharded``'s device stitch).  Without a process
    group it is ``assemble_sharded``.  ``cap_per_dest`` sizes JAX's
    exchange buffers and is unused.  ``stats``: see
    ``parallel.sharded_tables``; with ``exchange_bytes`` (sent to other
    processes), ``gather_s`` and ``gather_bytes`` (the ends' and the
    unitigs' all-gathers) and ``shard_unitigs`` (this process's shards'
    unitigs, which enter the stitch).
    """
    if mesh is None:
        mesh = global_mesh(device=device)
    return assemble_sharded(local_reads, k, p, stranded=stranded, min_obs=min_obs, mesh=mesh,
                            cap_per_dest=cap_per_dest, data_reduce_compress=data_reduce_compress,
                            device=device, stats=stats)


def assemble_multihost(paths: Sequence[str], k: int, p: int, **kwargs):
    """Read this process's slice of ``paths`` (:func:`local_read_slice`) and
    assemble over the global mesh (:func:`assemble_multiprocess`).  Every
    process calls this with the same arguments."""
    from tpu_debruijn_torch.io import read_fastx

    reads: List[np.ndarray] = []
    for path in local_read_slice(paths):
        reads.extend(read_fastx(path))
    return assemble_multiprocess(reads, k, p, **kwargs)
