"""MSP sharding: reads split into minimizer intervals, buckets counted and
compressed shard by shard, shard unitigs stitched into one graph.

Counterpart of ``tpu_debruijn/parallel`` (rust-debruijn's only scale-out
mechanism: msp.rs, filter.rs:238-276, the sharded test test.rs:418-504).
MSP puts every occurrence of a kmer in one bucket, so each shard's counts
are exact; only unitigs that cross shard boundaries need the stitch.

Here the shards are logical shards on one device (``make_mesh``); the
JAX package's ``all_to_all`` exchange and ``all_gather`` are a stable
partition and a concatenation.  ``assemble_multiprocess`` (several hosts)
is not ported yet.
"""

from tpu_debruijn_torch.parallel.mesh import LogicalMesh, make_mesh, shard_axis
from tpu_debruijn_torch.parallel.shard import (
    ShardPlan,
    assemble_sharded,
    dest_histogram,
    sharded_tables,
)

__all__ = [
    "LogicalMesh",
    "ShardPlan",
    "assemble_sharded",
    "dest_histogram",
    "make_mesh",
    "shard_axis",
    "sharded_tables",
]
