"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, in ``_build/``
beside the package (a directory git ignores).  The library's name carries a
hash of the sources and flags, so an edited source never loads a stale
build.  A plain C interface keeps the build at seconds: no PyTorch header
is compiled.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
:meth:`KernelLibrary.function` resolves an entry point and sets its ctypes
argument types once, so a launch costs one ctypes call.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


class KernelLibrary:
    """The loaded kernel library, with how long its build took."""

    def __init__(self, path: str, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.cdll = ctypes.CDLL(path)
        self._functions = {}

    def function(self, name: str, argtypes, restype=ctypes.c_int):
        """The C entry point ``name``, resolved with its argument and result
        types on first use and cached."""
        fn = self._functions.get(name)
        if fn is None:
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = restype
            self._functions[name] = fn
        return fn


_LIBRARY: Optional[KernelLibrary] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libtdb_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(out):
        log = _compile_and_link(srcs, out)
    _LIBRARY = KernelLibrary(out, time.perf_counter() - t0, log)
    return _LIBRARY


def _compile_and_link(srcs: list, out: str) -> str:
    """One nvcc per source, all running at once, then one link into
    ``out``; returns the compilers' output (``-Xptxas=-v``)."""
    nvcc = _nvcc()
    tag = f"{out}.{os.getpid()}"
    objs = [f"{tag}.{i}.o" for i in range(len(srcs))]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    try:
        for s, p, text in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(s)} ({p.returncode}):\n{text}")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", f"{tag}.tmp", *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(f"{tag}.tmp", out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
