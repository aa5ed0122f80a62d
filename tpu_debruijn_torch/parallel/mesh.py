"""The logical shard mesh: n MSP shards placed on one device."""

from __future__ import annotations

import dataclasses

import torch

SHARDS = "shards"


def shard_axis() -> str:
    return SHARDS


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """``n_shards`` logical shards on one ``device``.

    The JAX package runs one shard per device of a ``Mesh``; one card holds
    all of them here, and each shard's count and compression run in turn,
    so the count's peak memory is about one shard's.  The exchange and the
    stitch's gather are each one function of ``parallel.shard``
    (``exchange``, ``gather_ends``), where collectives across cards would
    go.
    """

    n_shards: int
    device: torch.device

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")


def make_mesh(n_shards: int = 8, device="cuda") -> LogicalMesh:
    """A mesh of ``n_shards`` logical shards (default 8, the mesh of the
    JAX package's tests) on ``device``."""
    return LogicalMesh(int(n_shards), torch.device(device))
