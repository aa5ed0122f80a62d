"""ctypes bindings for the port's host padding (``csrc/host_pad.cpp``).

:func:`library` builds the source at first use with the host C++ compiler
(:func:`~tpu_debruijn_torch.io.native.build_host_library`, into ``_build/``
under a name that carries a hash of the source and flags) against the
running interpreter's ``Python.h``, and loads it with ``ctypes.PyDLL``, so
the GIL is held while it walks Python objects.  A compiler error raises;
without a host compiler or ``Python.h`` it returns None and
:func:`~tpu_debruijn_torch.filter.pad_reads` pads in Python.

Each call walks rows ``[0, n)`` of a list or tuple and returns how many it
took: all of them, or the index of the first row it cannot take (see the
source), where the caller goes on in Python.
"""

from __future__ import annotations

import ctypes
import os
import sysconfig
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_pad.cpp")

_LIB: Optional[ctypes.PyDLL] = None
_TRIED = False


def _flags() -> Optional[list]:
    include = sysconfig.get_paths().get("include")
    if not include or not os.path.exists(os.path.join(include, "Python.h")):
        return None
    return ["-O3", "-fPIC", "-shared", "-std=c++17", f"-I{include}"]


def library() -> Optional[ctypes.PyDLL]:
    """The loaded padding library, built on first use; None where it cannot
    be built."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    from tpu_debruijn_torch.io.native import build_host_library  # io imports filter

    flags = _flags()
    path = None if flags is None else build_host_library(SOURCE, "tdb_host_pad", flags)
    _TRIED = True
    if path is None:
        return None
    lib = ctypes.PyDLL(path)
    obj, i32, i64 = ctypes.py_object, ctypes.c_int32, ctypes.c_int64
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    lib.tdb_pad_measure.argtypes = [obj, i64, i32, i32p, i32p, i32p]
    lib.tdb_pad_copy.argtypes = [obj, i64, i32, i32p, u8p, i64]
    lib.tdb_pad_measure.restype = lib.tdb_pad_copy.restype = i64
    _LIB = lib
    return _LIB


def _i32p(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def measure(lib, seqs, items: bool, lengths: np.ndarray, exts=None, labels=None) -> int:
    """Rows' lengths (and for ``items`` their exts, and their labels where
    ``labels`` is an array) into the (n,) int32 arrays; the rows taken."""
    return lib.tdb_pad_measure(seqs, lengths.shape[0], items, _i32p(lengths), _i32p(exts),
                               _i32p(labels))


def copy(lib, seqs, items: bool, lengths: np.ndarray, out: np.ndarray) -> int:
    """The bases of rows ``[0, n)``, n the rows ``lengths`` (int32, from
    :func:`measure`) holds, into ``out`` (C-contiguous (>= n, L) uint8),
    each row's tail zeroed; the rows taken."""
    return lib.tdb_pad_copy(seqs, lengths.shape[0], items, _i32p(lengths),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.shape[1])
