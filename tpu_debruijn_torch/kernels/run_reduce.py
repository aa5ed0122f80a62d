"""Per-run reductions of sorted rows: the count's exts OR and sums.

Kernel 6 of the port, ``csrc/run_reduce.cu``.  It replaces the JAX
package's packed segmented suffix scans, plain XLA associative scans:
``seg_or_suffix8`` (``tpu_debruijn/sorting.py:316``, the exts OR of
``count_kmers``) and ``_seg_sum_or_suffix`` (``tpu_debruijn/filter.py:1195``,
the count sum and exts OR of the corpus merge).  Both are read only at run
starts, so the port computes the per-run totals.

On the H100 the kernel is bound by device memory: it reads its columns in
place from the sorted packed observation rows (a 4-byte word of each 16- or
32-byte row), so no contiguous copy of a column is made.  It is one flat
pass, a warp to 512 consecutive rows, whatever the run lengths: a warp-level
segmented reduce, then one atomic a run and warp (``csrc/run_reduce.cu``).

:func:`run_reduce` launches the kernel for CUDA tensors and runs
:func:`run_reduce_plain` (one cumulative count a bit and one cumulative sum,
read at the run ends and differenced) for CPU tensors; ``run_reduce.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_debruijn_torch.kernels import _build

# (or_col, or_stride, sum_col, sum_stride, ends, n, u, or_out, sum_out, stream)
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def _rows(or_col, sum_col) -> torch.Tensor:
    col = or_col if or_col is not None else sum_col
    if col is None:
        raise ValueError("run_reduce: give or_col, sum_col or both")
    return col


def run_reduce_plain(ends: torch.Tensor, or_col: Optional[torch.Tensor] = None,
                     sum_col: Optional[torch.Tensor] = None) -> Tuple:
    """:func:`run_reduce` in plain PyTorch."""
    col = _rows(or_col, sum_col)
    u = ends.shape[0]
    last = ends - 1
    out_or = out_sum = None
    if or_col is not None:
        out_or = torch.zeros(u, dtype=torch.int32, device=col.device)
        vals = or_col.contiguous()
        for b in range(8):
            c = torch.cumsum((vals >> b) & 1, 0, dtype=torch.int32)[last]
            out_or |= (torch.diff(c, prepend=c.new_zeros(1)) > 0).to(torch.int32) << b
    if sum_col is not None:
        c = torch.cumsum(sum_col, 0, dtype=torch.int64)[last]
        out_sum = torch.diff(c, prepend=c.new_zeros(1))
    return out_or, out_sum


def run_reduce(ends: torch.Tensor, or_col: Optional[torch.Tensor] = None,
               sum_col: Optional[torch.Tensor] = None) -> Tuple:
    """Reduce each run of a partition of [0, n) into runs ending (exclusive)
    at ``ends`` ((U,) int64, strictly increasing, the last n).

    ``or_col``: (n,) int32, the OR of its low 8 bits over each run, (U,)
    int32.  ``sum_col``: (n,) int32, its int64 sum over each run, (U,) int64.
    Either column may be a strided view, such as a column of packed rows: the
    kernel reads it in place.  Returns (or, sum), None for a column not given;
    one launch computes both.
    """
    col = _rows(or_col, sum_col)
    if not col.is_cuda:
        if col.is_cpu:
            return run_reduce_plain(ends, or_col, sum_col)
        raise ValueError(f"run_reduce: no kernel for device {col.device}")
    dev, n, u = col.device, col.shape[0], ends.shape[0]
    for c in (or_col, sum_col):
        if c is not None and (c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n
                              or c.device != dev):
            raise ValueError("run_reduce: columns must be (n,) int32 on one device")
    if ends.dtype != torch.int64 or ends.dim() != 1 or ends.device != dev:
        raise ValueError("run_reduce: ends must be (U,) int64 on the columns' device")
    if n >= 1 << 31:
        raise ValueError("run_reduce: the kernel takes fewer than 2^31 rows")
    if u > n:
        raise ValueError(f"run_reduce: {u} runs of {n} rows")
    out_or = None if or_col is None else torch.zeros(u, dtype=torch.int32, device=dev)
    out_sum = None if sum_col is None else torch.zeros(u, dtype=torch.int64, device=dev)
    if n == 0 or u == 0:
        return out_or, out_sum
    ends = ends.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.library().function("tdb_run_reduce", _ARGTYPES)
    _build.check("tdb_run_reduce", fn(
        ptr(or_col), 0 if or_col is None else or_col.stride(0),
        ptr(sum_col), 0 if sum_col is None else sum_col.stride(0),
        ends.data_ptr(), n, u, ptr(out_or), ptr(out_sum), _build.stream_ptr(dev),
    ))
    run_reduce.launches += 1
    return out_or, out_sum


run_reduce.launches = 0
