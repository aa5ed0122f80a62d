"""The port's hand-written Hopper kernels (CUDA C++ in ``csrc/``).

Each wrapper launches its kernel for a CUDA tensor, runs its plain PyTorch
version for a CPU tensor, and counts its launches in ``<wrapper>.launches``.
"""

from tpu_debruijn_torch.kernels.canonical import canonicalize, canonicalize_plain
from tpu_debruijn_torch.kernels.extract_canonical import (
    extract_canonical,
    extract_canonical_plain,
    extract_canonical_tiled_plain,
    extract_kmers,
)
from tpu_debruijn_torch.kernels.gather import (
    gather_rows,
    gather_rows_plain,
    take_along_axis,
    take_along_axis_plain,
)
from tpu_debruijn_torch.kernels.msp_scan import (
    msp_scan,
    msp_scan_plain,
    msp_scan_reads,
    msp_scan_reads_plain,
)
from tpu_debruijn_torch.kernels.pointer_jump import (
    rank_lists,
    rank_lists_plain,
    rank_lists_rulers_plain,
    rank_loop,
    rank_loop_plain,
    rank_round_plain,
    successor_walk,
    successor_walk_plain,
)
from tpu_debruijn_torch.kernels.run_reduce import (
    run_reduce,
    run_reduce_plain,
    run_reduce_rows,
    run_reduce_rows_plain,
)

__all__ = [
    "canonicalize",
    "canonicalize_plain",
    "extract_canonical",
    "extract_canonical_plain",
    "extract_canonical_tiled_plain",
    "extract_kmers",
    "gather_rows",
    "gather_rows_plain",
    "msp_scan",
    "msp_scan_plain",
    "msp_scan_reads",
    "msp_scan_reads_plain",
    "rank_lists",
    "rank_lists_plain",
    "rank_lists_rulers_plain",
    "rank_loop",
    "rank_loop_plain",
    "rank_round_plain",
    "run_reduce",
    "run_reduce_plain",
    "run_reduce_rows",
    "run_reduce_rows_plain",
    "successor_walk",
    "successor_walk_plain",
    "take_along_axis",
    "take_along_axis_plain",
]
