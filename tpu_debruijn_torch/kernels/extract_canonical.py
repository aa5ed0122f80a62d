"""Fused kmer extraction: window pack, canonical min, Exts byte, validity.

Kernel 2 of the port, ``csrc/extract_canonical.cu``.  It replaces the
Pallas kernel ``tpu_debruijn/kernels/extract_canonical.py::_kernel`` (called
through ``_call`` / ``extract_canonical_fused``) and is the frontend of the
port's counting on CUDA.

On the H100 the kernel is bound by device memory on the write side: each
(read, position) slot reads one new base byte and writes 8W + 5 bytes.  The
bases go in as uint8, a quarter of the JAX kernel's int32 input, and each
output byte is written once.  A block packs a tile of rows into 2-bit words
in shared memory, forward and reverse-complement, and each slot's limbs are
funnel shifts of two words: O(W) work per slot whatever K is.
:func:`extract_canonical_tiled_plain` transcribes that algorithm in plain
PyTorch.

:func:`extract_canonical` launches the kernel for a CUDA tensor and runs
:func:`extract_canonical_plain` (:func:`extract_kmers` followed by the
canonical min) for a CPU tensor.  ``extract_canonical.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_debruijn_torch import exts as E
from tpu_debruijn_torch.kernels import _build
from tpu_debruijn_torch.kernels.canonical import canonicalize_plain
from tpu_debruijn_torch.kmer import M32, KmerSpec, reverse_by_twos_u32

# slots per piece at most: longer rows are cut into pieces (the kernel's
# shared-memory tile holds the packed words of whole pieces)
SEG_MAX = 2048
# slots per tile of a block, about (whole pieces, at most 64), chosen on the
# H100: PERF.md
TILE_SLOTS = 2048

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]


def extract_kmers(spec: KmerSpec, bases: torch.Tensor, lengths: torch.Tensor,
                  seq_exts: torch.Tensor):
    """All kmers + extension bytes of a padded read batch, plain PyTorch.

    Args:
      bases: (R, L) integer tensor of 2-bit codes (padding arbitrary)
      lengths: (R,) actual read lengths
      seq_exts: (R,) whole-read extension bytes (the Exts of the read
        within its parent string, filter.rs:116-124)

    Returns (kmers (R, Lk, W) int64, exts (R, Lk) int32, valid (R, Lk)
    bool), Lk = L - K + 1; slot s holds the kmer starting at base s.
    """
    k, w = spec.k, spec.w
    r, l = bases.shape
    if l < k:
        raise ValueError(f"padded read length {l} < K={k}")
    lk = l - k + 1
    b = bases.to(torch.int64)
    nb_low = k - 16 * (w - 1)
    limbs = []
    for j in range(w):
        c0 = 0 if j == 0 else nb_low + 16 * (j - 1)
        nb = nb_low if j == 0 else 16
        acc = torch.zeros((r, lk), dtype=torch.int64, device=bases.device)
        for t in range(c0, c0 + nb):
            acc = (acc << 2) | b[:, t : t + lk]
        limbs.append(acc)
    kmers = torch.stack(limbs, dim=-1)

    # extension bytes (KmerExtsIter semantics, lib.rs:809-842)
    bi = bases.to(torch.int32)
    se = seq_exts.to(torch.int32)[:, None]
    lens = lengths.to(torch.int32)[:, None]
    left_nib = torch.cat([se & 0x0F, 1 << bi[:, : lk - 1]], dim=1)
    rb = torch.nn.functional.pad(bi[:, k:], (0, 1))  # base at s + k
    pos = torch.arange(lk, dtype=torch.int32, device=bases.device)[None, :]
    right_nib = torch.where(pos == lens - k, (se >> 4) & 0x0F, 1 << rb)
    exts = (left_nib & 0x0F) | ((right_nib & 0x0F) << 4)
    return kmers, exts, pos <= lens - k


def extract_canonical_plain(spec: KmerSpec, bases, lengths, seq_exts, stranded: bool):
    """:func:`extract_kmers` + canonical min (filter.rs:190-196), plain PyTorch."""
    kmers, exts, valid = extract_kmers(spec, bases, lengths, seq_exts)
    if stranded:
        return kmers, exts, valid
    r, lk = exts.shape
    ck, ce, _ = canonicalize_plain(spec, kmers.reshape(r * lk, spec.w), exts.reshape(-1))
    return ck.reshape(r, lk, spec.w), ce.reshape(r, lk), valid


def tile_layout(l: int, k: int, seg_max: int = SEG_MAX):
    """The kernel's cut of a row: (Lk, NW words of 16 bases, SEG slots per
    piece, pieces per row, words kept per piece and strand)."""
    lk = l - k + 1
    seg = min(lk, seg_max)
    return lk, -(-l // 16), seg, -(-lk // seg), ((seg + k) >> 4) + 3


def extract_canonical_tiled_plain(spec: KmerSpec, bases, lengths, seq_exts, stranded: bool,
                                  seg_max: int = SEG_MAX):
    """The tile algorithm of ``csrc/extract_canonical.cu``, step for step in
    plain PyTorch (all pieces at once): :func:`extract_canonical_plain`'s
    result from packed words and funnel shifts.

    Each row is cut into pieces of at most ``seg_max`` slots.  A piece keeps
    the 2-bit words (16 bases, first base in the top bits) of the chunks
    ``ca..cb`` its windows and neighbours touch, and for the rc strand the
    complemented, reversed words of the row padded to 16 NW bases, then a
    zero word.  A slot's limbs are funnel shifts of two words each.
    """
    k, w = spec.k, spec.w
    r, l = bases.shape
    if l < k:
        raise ValueError(f"padded read length {l} < K={k}")
    lk, nw, seg, nseg, wst = tile_layout(l, k, seg_max)
    dev = bases.device
    # chunk words of every row; bytes past L read 0
    b = torch.zeros((r, nw * 16), dtype=torch.int64, device=dev)
    b[:, :l] = bases.to(torch.int64) & 3
    f = (b.reshape(r, nw, 16) << (30 - 2 * torch.arange(16, device=dev))).sum(-1)
    rcw = ~reverse_by_twos_u32(f) & M32  # rc word nw - 1 - c of chunk c
    # pieces and their local words (one zero pad word after the last)
    pc = torch.arange(r * nseg, device=dev)
    row = pc // nseg
    s0 = (pc % nseg) * seg
    s1 = (s0 + seg).clamp(max=lk)
    ca = ((s0 - 1) >> 4).clamp(min=0)
    cb = ((s1 - 1 + k) >> 4).clamp(max=nw - 1)
    cl = torch.arange(wst, device=dev)
    c = ca[:, None] + cl
    fw = torch.where(c <= cb[:, None], f[row[:, None], c.clamp(max=nw - 1)], 0)
    c = cb[:, None] - cl
    rw = torch.where(c >= ca[:, None], rcw[row[:, None], c.clamp(min=0)], 0)

    sl = s0[:, None] + torch.arange(seg, device=dev)
    live = sl < s1[:, None]
    sl = torch.where(live, sl, s0[:, None])

    def funnel(words, i, bit):
        hi = torch.gather(words, 1, i)
        lo = torch.gather(words, 1, i + 1)
        return ((hi << bit) | (lo >> (32 - bit))) & M32

    nb_low = k - 16 * (w - 1)
    fwd, rev = [], []
    for j in range(w):
        c0, nb = (0, nb_low) if j == 0 else (nb_low + 16 * (j - 1), 16)
        p = sl + c0
        fwd.append(funnel(fw, (p >> 4) - ca[:, None], 2 * (p & 15)) >> (32 - 2 * nb))
        q = 16 * nw - k - sl + c0
        rev.append(funnel(rw, (q >> 4) - (nw - 1 - cb[:, None]), 2 * (q & 15)) >> (32 - 2 * nb))
    fwd, rev = torch.stack(fwd, -1), torch.stack(rev, -1)
    flip = torch.zeros(sl.shape, dtype=torch.bool, device=dev)
    if not stranded:
        lt = torch.zeros_like(flip)
        eq = torch.ones_like(flip)
        for j in range(w):
            lt = lt | (eq & (fwd[..., j] < rev[..., j]))
            eq = eq & (fwd[..., j] == rev[..., j])
        flip = ~lt
    kmers = torch.where(flip[..., None], rev, fwd)

    def base(p):  # the base at row position p, from the forward words
        word = torch.gather(fw, 1, ((p >> 4) - ca[:, None]).clamp(min=0))
        return (word >> (30 - 2 * (p & 15))) & 3

    se = seq_exts.to(torch.int64)[row][:, None]
    lens = lengths.to(torch.int64)[row][:, None]
    left = torch.where(sl == 0, se & 0x0F, 1 << base(sl - 1))
    rb = torch.where(sl + k < l, base((sl + k).clamp(max=16 * nw - 1)), 0)
    right = torch.where(sl == lens - k, (se >> 4) & 0x0F, 1 << rb)
    ex = (left & 0x0F) | ((right & 0x0F) << 4)
    ex = torch.where(flip, E.rc(ex), ex).to(torch.int32)
    valid = sl <= lens - k
    return (kmers[live].reshape(r, lk, w), ex[live].reshape(r, lk),
            valid[live].reshape(r, lk))


def extract_canonical(spec: KmerSpec, bases: torch.Tensor, lengths: torch.Tensor,
                      seq_exts: torch.Tensor, stranded: bool):
    """(R, L) uint8 codes -> (kmers (R, Lk, W) int64, exts (R, Lk) int32,
    valid (R, Lk) bool): the counting frontend, canonical unless stranded."""
    if bases.device.type == "cpu":
        return extract_canonical_plain(spec, bases, lengths, seq_exts, stranded)
    if bases.device.type != "cuda":
        raise ValueError(f"extract_canonical: no kernel for device {bases.device}")
    r, l = bases.shape
    k, w = spec.k, spec.w
    if l < k:
        raise ValueError(f"padded read length {l} < K={k}")
    if bases.dtype != torch.uint8:
        raise ValueError("extract_canonical: bases must be uint8")
    for name, t in (("lengths", lengths), ("seq_exts", seq_exts)):
        if t.shape != (r,) or t.dtype != torch.int32 or t.device != bases.device:
            raise ValueError(f"extract_canonical: {name} must be ({r},) int32 on the bases' device")
    bases = bases.contiguous()
    lengths = lengths.contiguous()
    seq_exts = seq_exts.contiguous()
    lk = l - k + 1
    kmers = torch.empty((r, lk, w), dtype=torch.int64, device=bases.device)
    exts = torch.empty((r, lk), dtype=torch.int32, device=bases.device)
    valid = torch.empty((r, lk), dtype=torch.bool, device=bases.device)
    if r == 0:
        return kmers, exts, valid
    fn = _build.library().function("tdb_extract_canonical", _ARGTYPES)
    _build.check("tdb_extract_canonical", fn(
        bases.data_ptr(), lengths.data_ptr(), seq_exts.data_ptr(), r, l, k,
        int(stranded), SEG_MAX, TILE_SLOTS, kmers.data_ptr(), exts.data_ptr(), valid.data_ptr(),
        _build.stream_ptr(bases.device),
    ))
    extract_canonical.launches += 1
    return kmers, exts, valid


extract_canonical.launches = 0
