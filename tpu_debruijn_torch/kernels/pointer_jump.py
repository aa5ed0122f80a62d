"""Pointer jumping: a successor walk, and one round of pointer doubling.

Kernels 5 and 6 of the port, ``csrc/pointer_jump.cu``.

- :func:`successor_walk` replaces the Pallas probe
  ``scripts/probe_pallas_gather.py::k4``: ``steps`` hops of
  ``s <- succ[s]`` through the original, fixed table (-1 is terminal).  It
  is a walk, not pointer doubling, so the whole walk is one launch.
- :func:`rank_round` is the round that probe was designed for: one
  synchronous round of ``compress._rank_all`` on the (m, 4) int32 carry
  ``[succ, dist, mnmo, end]``, with the update rule of
  ``tpu_debruijn/compress.py:281-295``.  It runs on both chain linkers.

On the H100 both are bound by the latency of random 16-byte reads.  A round
reads its own row and its successor's row with one 16-byte load each and
writes to a second buffer (an in-place round would let ``dist`` and the
min lane depend on thread scheduling), and it raises a device flag when a
pointer is still unresolved, so the caller reads 4 bytes per round instead
of reducing over the carry.

Both wrappers launch their kernel for a CUDA tensor and run the plain
PyTorch version (``*_plain``) for a CPU tensor; ``.launches`` counts kernel
launches.  ``dist`` adds in int32 and wraps on overflow in both versions.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_debruijn_torch.kernels import _build

_WALK_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]
_ROUND_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def successor_walk_plain(succ: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` times ``s = where(s >= 0, succ[clamp(s)], s)`` from
    ``s = succ``, plain PyTorch."""
    m = succ.shape[0]
    s = succ
    for _ in range(steps):
        s = torch.where(s >= 0, succ[s.clamp(0, max(m - 1, 0))], s)
    return s


def successor_walk(succ: torch.Tensor, steps: int) -> torch.Tensor:
    """(M,) int32 successors (-1 terminal) -> where each element stands after
    ``steps`` further hops through the same table."""
    if succ.device.type == "cpu":
        return successor_walk_plain(succ, steps)
    if succ.device.type != "cuda":
        raise ValueError(f"successor_walk: no kernel for device {succ.device}")
    if succ.dtype != torch.int32 or succ.dim() != 1:
        raise ValueError("successor_walk: succ must be (M,) int32")
    if steps < 0:
        raise ValueError("successor_walk: steps must be >= 0")
    succ = succ.contiguous()
    out = torch.empty_like(succ)
    if succ.numel() == 0:
        return out
    fn = _build.library().function("tdb_successor_walk", _WALK_ARGTYPES)
    _build.check("tdb_successor_walk", fn(
        succ.data_ptr(), succ.shape[0], steps, out.data_ptr(),
        _build.stream_ptr(succ.device),
    ))
    successor_walk.launches += 1
    return out


successor_walk.launches = 0


def rank_round_plain(x: torch.Tensor, out=None):
    """One doubling round on the (m, 4) int32 carry, plain PyTorch: the loop
    body of ``_rank_all``.  Returns (next carry, unresolved) with
    ``unresolved`` a (1,) int32 tensor, 1 iff some next ``succ`` is >= 0."""
    m = x.shape[0]
    s = x[:, 0]
    has = s >= 0
    g = x[s.clamp(0, max(m - 1, 0))]
    nxt = torch.stack([
        torch.where(has, g[:, 0], s),
        x[:, 1] + torch.where(has, g[:, 1], 0),
        torch.where(has, torch.minimum(x[:, 2], g[:, 2]), x[:, 2]),
        torch.where(has, g[:, 3], x[:, 3]),
    ], dim=1, out=out)
    return nxt, (nxt[:, 0] >= 0).any().to(torch.int32).reshape(1)


def rank_round(x: torch.Tensor, out=None):
    """One synchronous pointer-doubling round on the (m, 4) int32 carry
    ``[succ, dist, mnmo, end]``: every row with ``succ >= 0`` takes its
    successor's succ and end, adds its dist and keeps the min of mnmo.

    ``out`` (optional, (m, 4) int32, not ``x``) receives the next carry.
    Returns (next carry, unresolved), ``unresolved`` a (1,) int32 tensor on
    ``x``'s device, 1 iff some next ``succ`` is >= 0.
    """
    if x.device.type == "cpu":
        return rank_round_plain(x, out)
    if x.device.type != "cuda":
        raise ValueError(f"rank_round: no kernel for device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 4:
        raise ValueError("rank_round: the carry must be (m, 4) int32")
    x = x.contiguous()
    if x.data_ptr() % 16:  # rows are read with 16-byte loads
        x = x.clone()
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous() or out.data_ptr() % 16 or out.data_ptr() == x.data_ptr()):
        raise ValueError("rank_round: out must be a distinct, aligned (m, 4) int32 buffer")
    if x.shape[0] == 0:
        return out, torch.zeros(1, dtype=torch.int32, device=x.device)
    unresolved = torch.empty(1, dtype=torch.int32, device=x.device)
    fn = _build.library().function("tdb_rank_round", _ROUND_ARGTYPES)
    _build.check("tdb_rank_round", fn(
        x.data_ptr(), x.shape[0], out.data_ptr(), unresolved.data_ptr(),
        _build.stream_ptr(x.device),
    ))
    rank_round.launches += 1
    return out, unresolved


rank_round.launches = 0
