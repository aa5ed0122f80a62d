"""ctypes bindings for the port's host codec (``csrc/host_codec.cpp``).

A copy of ``tpu_debruijn/io/native.py`` that loads nothing of the JAX
package.  The codec's source is the port's own copy of
``native/debruijn_native.cpp``; :func:`_build_library` compiles it with the
host C++ compiler at first use into ``_build/`` beside the package (a
directory git ignores), under a name that carries a hash of the source and
flags, so an edited source never loads a stale build and several processes
may build at once.  A compiler error raises.  Without a host compiler the
NumPy codec below does the same work; both are host code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_codec.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def build_host_library(source: str, stem: str, flags) -> Optional[str]:
    """The path of ``source`` built by the host C++ compiler with ``flags``
    into ``_build/lib{stem}_<hash>.so`` (once per source and flags hash) if
    it is not there; None when no host C++ compiler is found.  A compiler
    error raises."""
    with open(source, "rb") as f:
        h = hashlib.sha256(" ".join(flags).encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *flags, "-o", tmp, source], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {os.path.basename(source)} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _build_library() -> Optional[str]:
    """The codec library's path (:func:`build_host_library`)."""
    return build_host_library(SOURCE, "tdb_host_codec", CXX_FLAGS)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    path = _build_library()
    _TRIED = True
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.db_ascii_to_codes.restype = ctypes.c_int64
    lib.db_ascii_to_codes.argtypes = [u8p, ctypes.c_int64, u8p, u8p]
    lib.db_codes_to_ascii.restype = None
    lib.db_codes_to_ascii.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.db_pack_codes_u32.restype = None
    lib.db_pack_codes_u32.argtypes = [u8p, ctypes.c_int64, u32p]
    lib.db_unpack_codes_u32.restype = None
    lib.db_unpack_codes_u32.argtypes = [u32p, ctypes.c_int64, u8p]
    lib.db_rc_codes.restype = None
    lib.db_rc_codes.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.db_fastx_scan.restype = ctypes.c_int64
    lib.db_fastx_scan.argtypes = [u8p, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
    lib.db_fastx_extract.restype = ctypes.c_int64
    lib.db_fastx_extract.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p, i64p]
    lib.db_fastx_extract_flat.restype = ctypes.c_int64
    lib.db_fastx_extract_flat.argtypes = [u8p, i64p, i64p, ctypes.c_int64, u8p, i64p]
    lib.db_fastx_extract_batch.restype = ctypes.c_int64
    lib.db_fastx_extract_batch.argtypes = [u8p, i64p, i64p, ctypes.c_int64, u8p, ctypes.c_int64, i32p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def ascii_to_codes(ascii_bytes, with_mask: bool = False):
    """ASCII -> 2-bit codes; invalid chars become 0.

    Returns codes, or (codes, valid_mask, n_invalid) if with_mask.
    base_to_bits / dna_only_base_to_bits equivalent (lib.rs:65-92) on the
    bulk path.
    """
    arr = np.frombuffer(bytes(ascii_bytes), dtype=np.uint8).copy() if not isinstance(
        ascii_bytes, np.ndarray
    ) else np.ascontiguousarray(ascii_bytes, np.uint8)
    n = len(arr)
    codes = np.empty(n, np.uint8)
    lib = _load()
    if lib is not None:
        mask = np.empty(n, np.uint8) if with_mask else None
        bad = lib.db_ascii_to_codes(
            _u8p(arr), n, _u8p(codes), _u8p(mask) if with_mask else None
        )
        if with_mask:
            return codes, mask.astype(bool), int(bad)
        return codes
    # NumPy fallback
    x = (arr >> 1) & 3
    codes = (x ^ ((x >> 1) & 1)).astype(np.uint8)
    up = arr & 0xDF
    ok = (up == 65) | (up == 67) | (up == 71) | (up == 84)
    codes[~ok] = 0
    if with_mask:
        return codes, ok, int((~ok).sum())
    return codes


def codes_to_ascii(codes: np.ndarray) -> bytes:
    codes = np.ascontiguousarray(codes, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(len(codes), np.uint8)
        lib.db_codes_to_ascii(_u8p(codes), len(codes), _u8p(out))
        return out.tobytes()
    return np.frombuffer(b"ACGT", np.uint8)[codes & 3].tobytes()


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """2-bit codes -> uint32 words (16/word, MSB-first)."""
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    nw = -(-n // 16) if n else 0
    lib = _load()
    if lib is not None:
        out = np.empty(nw, np.uint32)
        lib.db_pack_codes_u32(_u8p(codes), n, _u32p(out))
        return out
    from tpu_debruijn_torch.dna import pack_bases

    return pack_bases(codes)


def unpack_codes(words: np.ndarray, length: int) -> np.ndarray:
    words = np.ascontiguousarray(words, np.uint32)
    lib = _load()
    if lib is not None:
        out = np.empty(length, np.uint8)
        lib.db_unpack_codes_u32(_u32p(words), length, _u8p(out))
        return out
    from tpu_debruijn_torch.dna import unpack_bases

    return unpack_bases(words, length)


def rc_codes(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.empty(len(codes), np.uint8)
        lib.db_rc_codes(_u8p(codes), len(codes), _u8p(out))
        return out
    return (3 - codes[::-1]).astype(np.uint8)


def fastx_scan(buf: np.ndarray, max_records: int) -> Tuple[np.ndarray, np.ndarray, int]:
    lib = _load()
    rs = np.empty(max_records, np.int64)
    re_ = np.empty(max_records, np.int64)
    n = lib.db_fastx_scan(_u8p(buf), len(buf), _i64p(rs), _i64p(re_), max_records)
    return rs, re_, int(n)


def fastx_extract(buf: np.ndarray, start: int, end: int):
    """Decode one record span; returns (codes, n_invalid).  Calls are
    counted in ``fastx_extract.calls``."""
    lib = _load()
    codes = np.empty(end - start, np.uint8)
    bad = np.zeros(1, np.int64)
    m = lib.db_fastx_extract(_u8p(buf), start, end, _u8p(codes), _i64p(bad))
    fastx_extract.calls += 1
    return codes[:m], int(bad[0])


fastx_extract.calls = 0


def fastx_extract_flat(buf: np.ndarray, rec_start: np.ndarray, rec_end: np.ndarray):
    """Decode many record spans in one native call into one flat code
    buffer: record ``r`` is ``codes[offsets[r]:offsets[r + 1]]``, the codes
    :func:`fastx_extract` gives for its span.  Returns (codes, offsets,
    n_invalid); ``offsets`` is int64 of length ``m + 1``.  Calls are counted
    in ``fastx_extract_flat.calls``."""
    lib = _load()
    rs = np.ascontiguousarray(rec_start, np.int64)
    re_ = np.ascontiguousarray(rec_end, np.int64)
    spans = re_ - rs  # a span's length bounds its record's codes
    if len(rs) and (spans.min() < 0 or rs.min() < 0 or re_.max() > len(buf)):
        raise ValueError("record spans must satisfy 0 <= start <= end <= len(buf)")
    m = len(rs)
    codes = np.empty(int(spans.sum()), np.uint8)
    offsets = np.empty(m + 1, np.int64)
    bad = lib.db_fastx_extract_flat(_u8p(buf), _i64p(rs), _i64p(re_), m, _u8p(codes),
                                    _i64p(offsets))
    fastx_extract_flat.calls += 1
    return codes[: offsets[m]], offsets, int(bad)


fastx_extract_flat.calls = 0


def fastx_extract_batch(buf: np.ndarray, rec_start: np.ndarray, rec_end: np.ndarray,
                        row_stride: int):
    """Decode a batch of record spans into one (m, row_stride) row matrix
    packed 2 bits a base (4 bases a byte, little-endian in the byte: the
    streaming upload format, ``filter.unpack_2bit``) and per-record
    lengths, in one native call.  Returns (rows, lengths, n_invalid)."""
    lib = _load()
    rs = np.ascontiguousarray(rec_start, np.int64)
    re_ = np.ascontiguousarray(rec_end, np.int64)
    m = len(rs)
    rows = np.empty((m, row_stride), np.uint8)
    lengths = np.empty(m, np.int32)
    bad = lib.db_fastx_extract_batch(
        _u8p(buf), _i64p(rs), _i64p(re_), m, _u8p(rows), row_stride,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return rows, lengths, int(bad)
