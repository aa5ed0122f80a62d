"""The logical shard mesh: n MSP shards on one device, or over every process
of a ``torch.distributed`` group (one device a process)."""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

SHARDS = "shards"


def shard_axis() -> str:
    return SHARDS


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """``n_shards`` logical shards on one ``device``, or over ``world``
    processes.

    The JAX package runs one shard per device of a ``Mesh``; one card holds
    a process's shards here, and each shard's count and compression run in
    turn, so the count's peak memory is about one shard's.  Process
    ``rank`` of ``world`` owns the contiguous block of shards
    :attr:`local`, as JAX's global mesh puts each host's devices in process
    order.  With ``distributed`` (a mesh of :func:`global_mesh` under a
    process group) the exchange and the stitch's gathers
    (``parallel.shard.exchange``, ``gather_ends``, ``gather_unitigs``) are
    collectives of the default group; otherwise they stay on the device.
    """

    n_shards: int
    device: torch.device
    rank: int = 0
    world: int = 1
    distributed: bool = False

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is not a process of {self.world}")
        if self.world > 1 and not self.distributed:
            raise ValueError("a mesh over several processes must be distributed")
        if self.n_shards % self.world:
            raise ValueError(f"{self.n_shards} shards do not split evenly over "
                             f"{self.world} processes")

    @property
    def local(self) -> range:
        """The shards this process counts and compresses."""
        per = self.n_shards // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_shards: int = 8, device="cuda") -> LogicalMesh:
    """A mesh of ``n_shards`` logical shards (default 8, the mesh of the
    JAX package's tests) on ``device``."""
    return LogicalMesh(int(n_shards), torch.device(device))


def global_mesh(n_shards: int = 8, device="cuda") -> LogicalMesh:
    """A mesh of ``n_shards`` shards over every process of the default
    process group, this process's block of them on ``device`` (with several
    cards on a host, pass ``cuda:{local_rank}``).  Without a process group
    it is :func:`make_mesh`.  ``n_shards`` must be a multiple of the world
    size."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(n_shards, device)
    return LogicalMesh(int(n_shards), torch.device(device), dist.get_rank(),
                       dist.get_world_size(), distributed=True)
