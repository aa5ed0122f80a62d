"""Per-run reductions of sorted rows: the count's run boundaries, counts,
exts OR, head rows and labels.

Kernel 6 of the port, ``csrc/run_reduce.cu``.  It replaces the JAX
package's packed segmented suffix scans, plain XLA associative scans:
``seg_or_suffix8`` (``tpu_debruijn/sorting.py:316``, the exts OR of
``count_kmers``) and ``_seg_sum_or_suffix`` (``tpu_debruijn/filter.py:1195``,
the count sum and exts OR of the corpus merge), with the run boundaries,
counts, head rows and label reductions of the count around them.  Two forms:

* :func:`run_reduce_rows`, the count's whole tail: one pass over the sorted
  packed observation rows (``filter.pack_obs_rows``) that finds each run of
  equal keys and writes one row a run, compacted, by default in place over
  the front of the input.  One launch, one host read (the number of runs).
* :func:`run_reduce`, for callers that hold columns and run ends: the OR of
  one column's low byte and the sum of another over each run.

On the H100 both are bound by device memory.  The rows form reads each row
once with 16-byte loads and finds run numbers by a decoupled look-back over
tiles (a single pass, no atomics on outputs, whatever the run lengths); the
ends form reads a 4-byte column in place, a warp to 512 consecutive rows.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (:func:`run_reduce_rows_plain`, :func:`run_reduce_plain`) for CPU
tensors; ``<wrapper>.launches`` counts kernel launches.
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
# (in, out, n, w, by_label, op, scratch, stream)
_ROWS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
]

COUNT_MAX = 65535  # a run's count saturates at u16, as in the reference
# what becomes of a run's label words, in the kernel's numbering
LABEL_OPS = ("first", "min", "max", "sum", "none")


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


# ---------------------------------------------------------------------------
# the rows form
# ---------------------------------------------------------------------------


def _rows_check(srows: torch.Tensor, w: int, label_op: str, out) -> torch.Tensor:
    if label_op not in LABEL_OPS:
        raise ValueError(f"run_reduce_rows: unknown label_op {label_op!r}")
    if not 1 <= w <= 4:
        raise ValueError(f"run_reduce_rows: rows of W = {w} limbs")
    rw = 4 if w <= 2 else 8
    if srows.dim() != 2 or srows.dtype != torch.int32 or srows.shape[1] != rw:
        raise ValueError(f"run_reduce_rows: srows must be (n, {rw}) int32 packed rows")
    out = srows if out is None else out
    if (out.dim() != 2 or out.dtype != torch.int32 or out.shape[1] != rw
            or out.shape[0] < srows.shape[0] or out.device != srows.device):
        raise ValueError("run_reduce_rows: out must hold n rows like srows, on its device")
    return out


def _key(srows: torch.Tensor, w: int, by_label: bool) -> torch.Tensor:
    return torch.cat([srows[:, :w], srows[:, w + 1 : w + 2]], dim=1) if by_label else srows[:, :w]


def run_reduce_rows_plain(srows: torch.Tensor, w: int, by_label: bool = False,
                          label_op: str = "first", out: Optional[torch.Tensor] = None):
    """:func:`run_reduce_rows` in plain PyTorch: run starts by comparing
    neighbours, then one reduction a field over the run numbers."""
    out = _rows_check(srows, w, label_op, out)
    n, dev = srows.shape[0], srows.device
    if n == 0:
        return out[:0]
    key = _key(srows, w, by_label)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = (key[1:] != key[:-1]).any(dim=1)
    starts = torch.nonzero(is_start).flatten()
    u = starts.shape[0]
    run = torch.cumsum(is_start, 0) - 1
    counts = torch.bincount(run, minlength=u).clamp(max=COUNT_MAX).to(torch.int32)
    exts = srows[:, w] & 0xFF
    ors = torch.zeros(u, dtype=torch.int32, device=dev)
    for b in range(8):
        bit = torch.zeros(u, dtype=torch.int32, device=dev).scatter_reduce_(
            0, run, (exts >> b) & 1, "amax")
        ors |= bit << b
    lab = srows[:, w + 1]
    if label_op in ("min", "max"):
        data = torch.zeros(u, dtype=torch.int32, device=dev).scatter_reduce_(
            0, run, lab, "a" + label_op, include_self=False)
    elif label_op == "sum":  # wraps in int32
        data = torch.zeros(u, dtype=torch.int64, device=dev).index_add_(
            0, run, lab.to(torch.int64)).to(torch.int32)
    elif label_op == "first":
        data = lab[starts]
    else:
        data = torch.zeros(u, dtype=torch.int32, device=dev)
    heads = torch.zeros((u, srows.shape[1]), dtype=torch.int32, device=dev)
    heads[:, :w] = srows[starts, :w]
    heads[:, w] = (counts << 8) | ors
    heads[:, w + 1] = data
    out[:u] = heads
    return out[:u]


def run_reduce_rows(srows: torch.Tensor, w: int, by_label: bool = False,
                    label_op: str = "first", out: Optional[torch.Tensor] = None):
    """Reduce each run of equal keys of sorted packed observation rows
    (``filter.pack_obs_rows``: (n, 4) int32 at W <= 2, (n, 8) at W = 3, 4)
    to one row.

    A run is a maximal range of rows with equal keys: the W limb words, and
    with ``by_label`` also the label word (word W + 1).  Run r's row, at
    ``out[r]``: its key words; in word W, ``(min(count, 65535) << 8) |`` the
    OR of the low bytes of its exts words; in word W + 1 its label words
    reduced by ``label_op``: "first" (the head's; the stable sort keeps the
    first observation there), "min" / "max" (signed), "sum" (wrapping in
    int32) or "none" (0); zero elsewhere.

    ``out`` (capacity n rows) defaults to ``srows``: the runs are written in
    place over its front, and the rest of ``srows`` is left undefined.
    Returns ``out[:u]``, u the number of runs: one launch and one host read.
    """
    out = _rows_check(srows, w, label_op, out)
    if not srows.is_cuda:
        if srows.is_cpu:
            return run_reduce_rows_plain(srows, w, by_label, label_op, out)
        raise ValueError(f"run_reduce_rows: no kernel for device {srows.device}")
    n, rw = srows.shape
    if n >= 1 << 31:
        raise ValueError("run_reduce_rows: the kernel takes fewer than 2^31 rows")
    for t in (srows, out):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("run_reduce_rows: rows must be contiguous and 16-byte aligned")
    if n == 0:
        return out[:0]
    lib = _build.library()
    words = lib.function("tdb_run_reduce_rows_scratch", [ctypes.c_int64, ctypes.c_int],
                         ctypes.c_int64)
    scratch = torch.empty(words(n, rw), dtype=torch.int32, device=srows.device)
    fn = lib.function("tdb_run_reduce_rows", _ROWS_ARGTYPES)
    _build.check("tdb_run_reduce_rows", fn(
        srows.data_ptr(), out.data_ptr(), n, w, int(by_label), LABEL_OPS.index(label_op),
        scratch.data_ptr(), _build.stream_ptr(srows.device),
    ))
    run_reduce_rows.launches += 1
    return out[: int(scratch[1])]


run_reduce_rows.launches = 0
