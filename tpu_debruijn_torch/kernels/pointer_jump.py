"""Pointer jumping: a successor walk, the pointer-doubling loop, and list
ranking by a ruling set.

The walk and the loop are in ``csrc/pointer_jump.cu``, the ruling set (three
launches) in ``csrc/list_rank.cu``.

- :func:`successor_walk` replaces the Pallas probe
  ``scripts/probe_pallas_gather.py::k4``: ``steps`` hops of
  ``s <- succ[s]`` through the original, fixed table (-1 is terminal).  It
  is a walk, not pointer doubling, so the whole walk is one launch, one
  thread per element, its hops through L2.
- :func:`rank_loop` is the loop that probe was designed for: the
  ``lax.while_loop`` of ``compress._rank_all`` on the (m, 4) int32 carry
  ``[succ, dist, mnmo, end]``, with the update rule of
  ``tpu_debruijn/compress.py:281-295`` and, with ``early_exit``, its
  condition: stop after the first round that leaves no ``succ >= 0``.  One
  cooperative launch runs every round, with a grid barrier between rounds
  and the condition read on the card.  It ranks the ruler-level carry of
  :func:`rank_lists`, and every input :func:`rank_lists` leaves to it.
- :func:`rank_lists` is the whole ranking of ``compress._rank_all``: a
  sparse ruling set (one pass for predecessors and rulers, one backward walk
  per ruler, doubling over the rulers only, one expanding pass) in place of
  ceil(log2(m + 1)) doubling rounds over the whole carry.  Its plain version
  :func:`rank_lists_plain` is the doubling loop; :func:`rank_lists_rulers_plain`
  transcribes the kernels' algorithm step for step.

All of them are bound by dependent loads on the H100.  Each wrapper launches
its kernel for a CUDA tensor and runs the plain PyTorch version (``*_plain``)
for a CPU tensor; ``.launches`` counts kernel launches.  ``dist`` adds in int32
and wraps on overflow in both versions.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_debruijn_torch.kernels import _build

_WALK_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]
_LOOP_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p,
]
_LINKS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_WALK_RULERS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_EXPAND_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
# states per ruler on average (a power of two), chosen on the H100: PERF.md
RULER_SPACING = 64
# threads per block of rank_loop's cooperative launch (csrc/pointer_jump.cu)
LOOP_THREADS = 1024
_M32 = 0xFFFFFFFF
_INT32_MAX = 0x7FFFFFFF


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


def rank_round_plain(x: torch.Tensor):
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
    ], dim=1)
    return nxt, (nxt[:, 0] >= 0).any().to(torch.int32).reshape(1)


def rank_loop_plain(x: torch.Tensor, max_rounds: int, early_exit: bool = True):
    """``_rank_all``'s ``while_loop`` step for step, plain PyTorch: from
    ``(x, t = 0, active = True)``, while ``active and t < max_rounds``, one
    :func:`rank_round_plain`, ``t += 1`` and ``active`` = some ``succ >= 0``
    (always True without ``early_exit``).  Returns (final carry, t)."""
    cur, t, active = x, 0, True
    while active and t < max_rounds:
        cur, unresolved = rank_round_plain(cur)
        t += 1
        active = bool(unresolved) or not early_exit
    return cur, t


def rank_loop(x: torch.Tensor, max_rounds: int, early_exit: bool = True):
    """Up to ``max_rounds`` synchronous pointer-doubling rounds on the (m, 4)
    int32 carry ``[succ, dist, mnmo, end]``: every row with ``succ >= 0``
    takes its successor's succ and end, adds its dist and keeps the min of
    mnmo.  With ``early_exit`` the loop stops after the first round that
    leaves no ``succ >= 0``, as ``_rank_all``'s condition does.

    Returns (final carry, rounds): ``rounds`` is a (1,) int32 tensor on
    ``x``'s device holding the count of rounds run, which the caller need
    not read (``rank_loop.last_rounds`` keeps the latest).  On CUDA one
    cooperative launch; ``x`` is not modified.
    """
    if max_rounds < 1:
        raise ValueError("rank_loop: max_rounds must be >= 1")
    if x.device.type == "cpu":
        carry, t = rank_loop_plain(x, max_rounds, early_exit)
        rounds = torch.tensor([t], dtype=torch.int32)
    elif x.device.type != "cuda":
        raise ValueError(f"rank_loop: no kernel for device {x.device}")
    elif x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 4:
        raise ValueError("rank_loop: the carry must be (m, 4) int32")
    elif x.shape[0] == 0:  # the plain loop's one round on nothing
        carry, rounds = x.clone(), torch.ones(1, dtype=torch.int32, device=x.device)
    else:
        x = x.contiguous()
        if x.data_ptr() % 16:  # rows are read with 16-byte loads
            x = x.clone()
        carry, spare = torch.empty_like(x), torch.empty_like(x)
        state = torch.empty(max_rounds + 1, dtype=torch.int32, device=x.device)
        _build.check("tdb_rank_loop", _build.library().function("tdb_rank_loop", _LOOP_ARGTYPES)(
            x.data_ptr(), carry.data_ptr(), spare.data_ptr(), x.shape[0], max_rounds,
            int(early_exit), state.data_ptr(), _build.stream_ptr(x.device),
        ))
        rank_loop.launches += 1
        rounds = state[max_rounds:]
    rank_loop.last_rounds = rounds
    return carry, rounds


rank_loop.launches = 0
rank_loop.last_rounds = None


def rank_loop_grid(m: int) -> int:
    """The blocks of :func:`rank_loop`'s cooperative launch for m rows on the
    current CUDA device."""
    blocks = ctypes.c_uint(0)
    fn = _build.library().function("tdb_rank_loop_grid", [ctypes.c_int64, ctypes.c_void_p])
    _build.check("tdb_rank_loop_grid", fn(m, ctypes.addressof(blocks)))
    return blocks.value


def _full_rounds(m: int) -> int:
    """Doubling rounds after which every path of up to m states resolved and
    every cycle's min lane swept the cycle (2^rounds > m)."""
    return max(1, math.ceil(math.log2(m + 1)))


def rank_lists_plain(x: torch.Tensor) -> torch.Tensor:
    """Wyllie's pointer doubling on the (m, 4) int32 carry, plain PyTorch:
    :func:`rank_round_plain` until no pointer is open, at most
    ceil(log2(m + 1)) rounds.  Returns the final carry."""
    return rank_loop_plain(x, _full_rounds(x.shape[0]))[0]


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    # (a * c) mod 2^32 for a in [0, 2^32) with no int64 overflow
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hashed_ruler(i: torch.Tensor, spacing: int) -> torch.Tensor:
    """The kernels' ruler test for a state with a successor: its fmix32
    hash is 0 mod ``spacing``."""
    h = i.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & (spacing - 1)) == 0


def _check_spacing(spacing: int) -> None:
    if spacing < 1 or spacing & (spacing - 1) or spacing > 1 << 30:
        raise ValueError(f"rank_lists: ruler spacing {spacing} is not a power of two")


def _rank_apart(x: torch.Tensor, out: torch.Tensor, states: torch.Tensor) -> None:
    """Rank the sub-carry of ``states`` (closed under succ: every state on
    a cycle without a ruler) with one doubling loop, into ``out``."""
    relabel = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    relabel[states] = torch.arange(states.shape[0], device=x.device)
    sub = x[states]
    sub[:, 0] = relabel[sub[:, 0].to(torch.int64)].to(torch.int32)
    sub = rank_loop(sub, _full_rounds(states.shape[0]))[0]
    sub[:, 0] = states[sub[:, 0].to(torch.int64)].to(torch.int32)
    out[states] = sub


def rank_lists_rulers_plain(x: torch.Tensor, spacing: int = RULER_SPACING) -> torch.Tensor:
    """The ruling-set ranking of ``csrc/list_rank.cu``, step for step in
    plain PyTorch (the walks in lockstep): the CUDA path of
    :func:`rank_lists` gives the same carry in every lane.

    Resolved states equal :func:`rank_lists_plain`'s; a cycle state gets
    ``succ >= 0`` (a state of its cycle) and the cycle's minimum ``mnmo``,
    its ``dist``/``end`` are garbage.  An input where a state has two
    predecessors or a successor is out of range is ranked by doubling, as
    the kernel path does.
    """
    _check_spacing(spacing)
    m = x.shape[0]
    out = torch.empty_like(x)
    if m == 0:
        return out
    succ, d0, mn0, e0 = x.unbind(1)
    live = succ >= 0
    tgt = succ[live].to(torch.int64)
    # 1. links: predecessors, in-degree and range, rulers
    if bool((tgt >= m).any()) or int(torch.bincount(tgt, minlength=m).max()) > 1:
        return rank_lists_plain(x)
    pred = torch.full((m,), -1, dtype=torch.int64)
    pred[tgt] = torch.nonzero(live).flatten()
    idx = torch.arange(m)
    is_ruler = ~live | hashed_ruler(idx, spacing)
    rulers = torch.nonzero(is_ruler).flatten()
    nr = rulers.shape[0]
    rid = torch.full((m,), -1, dtype=torch.int64)
    rid[rulers] = torch.arange(nr)
    # 2. walks, every ruler one step per iteration
    y = torch.empty((nr, 4), dtype=torch.int32)
    term = ~live[rulers]
    y[term] = x[rulers[term]]
    seg = torch.zeros((m, 3), dtype=torch.int32)  # ruler index, seg_dist, seg_min
    visited = torch.zeros(m, dtype=torch.bool)
    j = torch.arange(nr)
    v = pred[rulers]
    acc_d = torch.zeros(nr, dtype=torch.int32)
    acc_m = torch.full((nr,), _INT32_MAX, dtype=torch.int32)
    while True:
        on = v >= 0
        j, v, acc_d, acc_m = j[on], v[on], acc_d[on], acc_m[on]
        if not v.numel():
            break
        stop = hashed_ruler(v, spacing)
        vs = v[stop]
        y[rid[vs]] = torch.stack([
            j[stop].to(torch.int32), d0[vs] + acc_d[stop],
            torch.minimum(mn0[vs], acc_m[stop]), e0[vs],
        ], dim=1)
        go = ~stop
        j, v, acc_d, acc_m = j[go], v[go], acc_d[go], acc_m[go]
        acc_d = acc_d + d0[v]
        acc_m = torch.minimum(acc_m, mn0[v])
        seg[v] = torch.stack([j.to(torch.int32), acc_d, acc_m], dim=1)
        visited[v] = True
        v = pred[v]
    # 3. the ruler level, one doubling loop
    if nr:
        y = rank_loop_plain(y, _full_rounds(nr))[0]
    back = lambda s: torch.where(s >= 0, rulers[s.clamp(min=0).to(torch.int64)].to(torch.int32), s)
    # 4. expand
    out[rulers] = torch.stack([back(y[:, 0]), y[:, 1], y[:, 2], y[:, 3]], dim=1)
    vi = torch.nonzero(visited).flatten()
    sv = seg[vi]
    r = y[sv[:, 0].to(torch.int64)]
    out[vi] = torch.stack([
        back(r[:, 0]), sv[:, 1] + r[:, 1], torch.minimum(sv[:, 2], r[:, 2]), r[:, 3],
    ], dim=1)
    # 5. cycles without a ruler
    rest = torch.nonzero(~visited & ~is_ruler).flatten()
    if rest.numel():
        _rank_apart(x, out, rest)
    return out


def rank_lists(x: torch.Tensor, spacing: int = RULER_SPACING) -> torch.Tensor:
    """List ranking on the (m, 4) int32 carry ``[succ, dist0, mnmo, end0]``:
    the final carry of pointer doubling on every state whose path ends
    (succ < 0, int32 dist sum along the path with the terminal, path min of
    mnmo, the terminal's end0), and on cycle states succ >= 0 with the
    cycle's minimum mnmo (dist and end garbage).

    On CUDA, the ruling set of ``csrc/list_rank.cu`` with ``spacing``
    states per ruler on average; an input with a state of in-degree above 1
    or a successor out of range is ranked by one :func:`rank_loop` launch
    instead (counted in ``rank_lists.round_path``).  On the CPU,
    :func:`rank_lists_plain`.  ``x`` is not modified.
    """
    if x.device.type == "cpu":
        return rank_lists_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"rank_lists: no kernel for device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 4:
        raise ValueError("rank_lists: the carry must be (m, 4) int32")
    _check_spacing(spacing)
    x = x.contiguous()
    if x.data_ptr() % 16:  # rows are read with 16-byte loads
        x = x.clone()
    m = x.shape[0]
    out = torch.empty_like(x)
    if m == 0:
        return out
    dev = x.device
    stream = _build.stream_ptr(dev)
    lib = _build.library()
    mask = spacing - 1
    pred = torch.empty(m, dtype=torch.int32, device=dev)
    tag = torch.empty(m, dtype=torch.uint8, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    _build.check("tdb_rank_lists_links", lib.function("tdb_rank_lists_links", _LINKS_ARGTYPES)(
        x.data_ptr(), m, mask, pred.data_ptr(), tag.data_ptr(), out.data_ptr(), flag.data_ptr(),
        stream,
    ))
    if int(flag):
        rank_lists.round_path += 1
        return rank_loop(x, _full_rounds(m))[0]
    del pred
    rulers = torch.nonzero(tag).flatten()
    nr = rulers.shape[0]
    rid = torch.empty(m, dtype=torch.int32, device=dev)
    y = torch.empty((nr, 4), dtype=torch.int32, device=dev)
    _build.check("tdb_rank_lists_walk", lib.function("tdb_rank_lists_walk", _WALK_RULERS_ARGTYPES)(
        x.data_ptr(), rulers.data_ptr(), nr, mask, rid.data_ptr(), out.data_ptr(), y.data_ptr(),
        stream,
    ))
    if nr:
        y = rank_loop(y, _full_rounds(nr))[0]
    _build.check("tdb_rank_lists_expand", lib.function("tdb_rank_lists_expand", _EXPAND_ARGTYPES)(
        y.data_ptr(), rulers.data_ptr(), rid.data_ptr(), tag.data_ptr(), m, out.data_ptr(),
        flag.data_ptr(), stream,
    ))
    rank_lists.launches += 1
    if int(flag):
        _rank_apart(x, out, torch.nonzero(tag == 0).flatten())
    return out


rank_lists.launches = 0
rank_lists.round_path = 0
