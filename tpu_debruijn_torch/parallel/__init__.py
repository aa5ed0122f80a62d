"""MSP sharding: reads split into minimizer intervals, buckets counted and
compressed shard by shard, shard unitigs stitched into one graph.

Counterpart of ``tpu_debruijn/parallel`` (rust-debruijn's only scale-out
mechanism: msp.rs, filter.rs:238-276, the sharded test test.rs:418-504).
MSP puts every occurrence of a kmer in one bucket, so each shard's counts
are exact; only unitigs that cross shard boundaries need the stitch.

On one process the shards are logical shards of one device
(``make_mesh``), and the JAX package's ``all_to_all`` exchange and
``all_gather`` are a stable partition and a concatenation.  Over several
processes (``multihost``: ``initialize``, ``global_mesh``,
``assemble_multiprocess``, ``assemble_multihost``) each process owns a
block of the shards on its own device, and they are
``torch.distributed`` collectives.
"""

from tpu_debruijn_torch.parallel.mesh import LogicalMesh, global_mesh, make_mesh, shard_axis
from tpu_debruijn_torch.parallel.multihost import (
    assemble_multihost,
    assemble_multiprocess,
    initialize,
    local_read_slice,
)
from tpu_debruijn_torch.parallel.shard import (
    ShardPlan,
    assemble_sharded,
    dest_histogram,
    sharded_tables,
)

__all__ = [
    "LogicalMesh",
    "ShardPlan",
    "assemble_multihost",
    "assemble_multiprocess",
    "assemble_sharded",
    "dest_histogram",
    "global_mesh",
    "initialize",
    "local_read_slice",
    "make_mesh",
    "shard_axis",
    "sharded_tables",
]
