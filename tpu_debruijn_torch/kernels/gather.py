"""Gathers: rows of a table by an index vector, and take_along_axis.

Kernels 3 and 4 of the port, ``csrc/gather.cu``.  They replace the Pallas
gather probes, which asked whether a TPU kernel could gather per lane from
a table held in on-chip memory (``scripts/probe_pallas_gather.py`` ``k1``,
``k2``, ``k3``; ``scripts/probe_pallas_gather2.py`` ``k_v1`` … ``k_v4``;
``scripts/probe_pallas_gather3.py`` ``k1``, ``k2``).  On the H100 a thread
loads from any address, so each gather is one pass bound by its random
reads (a whole 32-byte sector per row of up to 32 bytes): :func:`gather_rows`
moves such a row with one thread and 16-byte loads, and a wider row with
one warp.

:func:`gather_rows` carries the main path's row gathers on a CUDA tensor:
the count stage's valid-slot compaction and sort-permutation gathers of
the packed observation rows (``filter.count_kmers``), the LSD sort's key
and permutation gathers (``sorting.lex_argsort``), the table searches and
joins of edge resolution (``sorting.searchsorted_limbs``/``join_limbs``,
``compress._enforce_mutual``) and chain emission's per-state read
(``compress._emit_chains``).

Both wrappers launch their kernel for a CUDA tensor and run the plain
PyTorch version (``*_plain``) for a CPU tensor; ``.launches`` counts kernel
launches.  An index outside the gathered axis is clamped into it, in the
kernel and the plain version alike (JAX's indexing clamps the same way,
after wrapping a negative index).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_debruijn_torch.kernels import _build

# both entry points: (table, idx, int64, int64, int, idx_is_64, out, stream)
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]
_INDEX_TYPES = (torch.int32, torch.int64)


def _check_index(name: str, idx: torch.Tensor, device) -> None:
    if idx.dtype not in _INDEX_TYPES or idx.device != device:
        raise ValueError(f"{name}: indices must be int32 or int64 on the table's device")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, M - 1)]``, plain PyTorch."""
    return table[idx.clamp(0, max(table.shape[0] - 1, 0))]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, C) int32 or int64 table, (N,) int32 or int64 indices -> (N, C).

    Row ``i`` of the result is row ``idx[i]`` of ``table``; an index outside
    [0, M) is clamped into it.  A 1-D (M,) table gives (N,).
    """
    if not table.is_cuda:
        if table.is_cpu:
            return gather_rows_plain(table, idx)
        raise ValueError(f"gather_rows: no kernel for device {table.device}")
    dev = table.device
    shape = table.shape
    if table.dtype not in (torch.int32, torch.int64) or len(shape) not in (1, 2):
        raise ValueError("gather_rows: table must be (M,) or (M, C), int32 or int64")
    _check_index("gather_rows", idx, dev)
    if idx.dim() != 1:
        raise ValueError("gather_rows: indices must be 1-D")
    m, n = shape[0], idx.shape[0]
    out = torch.empty((n,) + shape[1:], dtype=table.dtype, device=dev)
    c = shape[1] if len(shape) == 2 else 1
    if n == 0 or c == 0:
        return out
    if m == 0:
        raise ValueError("gather_rows: gather from an empty table")
    table = table.contiguous()
    table_ptr = table.data_ptr()
    if table_ptr % 16:  # the kernel reads rows with 16-byte loads
        table = table.clone()
        table_ptr = table.data_ptr()
    idx = idx.contiguous()
    fn = _build.library().function("tdb_gather_rows", _ARGTYPES)
    _build.check("tdb_gather_rows", fn(
        table_ptr, idx.data_ptr(), m, n, c * table.element_size() // 4,
        idx.dtype == torch.int64, out.data_ptr(), _build.stream_ptr(dev),
    ))
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def take_along_axis_plain(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_dim(tab, clamp(idx), axis)``, plain PyTorch."""
    return torch.take_along_dim(tab, idx.long().clamp(0, tab.shape[axis] - 1), dim=axis)


def take_along_axis(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """(R, L) int32 table, (R, L) int32 or int64 indices -> (R, L).

    ``out[i, j] = tab[idx[i, j], j]`` for axis 0 and ``tab[i, idx[i, j]]``
    for axis 1 (``jnp.take_along_axis``); an index outside the axis is
    clamped into it.
    """
    if axis not in (0, 1):
        raise ValueError(f"take_along_axis: axis must be 0 or 1, not {axis}")
    if not tab.is_cuda:
        if tab.is_cpu:
            return take_along_axis_plain(tab, idx, axis)
        raise ValueError(f"take_along_axis: no kernel for device {tab.device}")
    if tab.dtype != torch.int32 or tab.dim() != 2:
        raise ValueError("take_along_axis: table must be (R, L) int32")
    _check_index("take_along_axis", idx, tab.device)
    if idx.shape != tab.shape:
        raise ValueError("take_along_axis: indices must have the table's shape")
    r, l = tab.shape
    if r * l >= 1 << 31:
        raise ValueError("take_along_axis: the kernel takes fewer than 2^31 elements")
    tab = tab.contiguous()
    out = torch.empty_like(tab)
    if r * l == 0:
        return out
    idx = idx.contiguous()
    fn = _build.library().function("tdb_take_along_axis", _ARGTYPES)
    _build.check("tdb_take_along_axis", fn(
        tab.data_ptr(), idx.data_ptr(), r, l, axis, idx.dtype == torch.int64,
        out.data_ptr(), _build.stream_ptr(tab.device),
    ))
    take_along_axis.launches += 1
    return out


take_along_axis.launches = 0
