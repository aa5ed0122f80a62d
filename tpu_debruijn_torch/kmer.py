"""Fixed-K kmer arithmetic on limb tensors (counterpart of ``tpu_debruijn/kmer.py``).

A kmer of K bases (1 <= K <= 64) is a 2K-bit integer held in
``W = ceil(K/16)`` 32-bit limbs, **most-significant limb first**, with the
value right-aligned in the low 2K bits: the layout of the JAX package.
Base 0 (leftmost in the string) occupies the most significant 2 bits, so
comparing limb tuples lexicographically compares kmer strings.

PyTorch on the CPU has no shifts or ordered compares for ``uint32``, so
each limb is an ``int64`` in ``[0, 2**32)``.  Every shift that can carry
past bit 31 is masked back to 32 bits.  The host converters below work on
the reference's numpy ``uint32`` arrays; :func:`to_torch` and
:func:`to_numpy` cross between the two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_debruijn_torch import bases as B

UMAX = np.uint32(0xFFFFFFFF)
M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class KmerSpec:
    """Static description of a kmer width."""

    k: int

    def __post_init__(self):
        if not (1 <= self.k <= 64):
            raise ValueError(f"K must be in 1..64, got {self.k}")

    @property
    def w(self) -> int:
        """Number of 32-bit limbs."""
        return (self.k + 15) // 16

    @property
    def nbits(self) -> int:
        return 2 * self.k

    @property
    def pad(self) -> int:
        """Zero bits above the value in the top limb; always in [0, 32)."""
        return 32 * self.w - 2 * self.k

    @property
    def top_mask(self) -> np.uint32:
        return np.uint32(UMAX >> np.uint32(self.pad))

    def limb_mask(self, i: int) -> np.uint32:
        return self.top_mask if i == 0 else UMAX


# ---------------------------------------------------------------------------
# host conversion (numpy uint32, as in the JAX package)
# ---------------------------------------------------------------------------


def from_bases_batch_np(spec: KmerSpec, rows: np.ndarray) -> np.ndarray:
    """Host-vectorized: (N, K) base codes -> (N, W) uint32 limbs.

    Left-pads each row to 16W bases so the packed value lands right-aligned
    (the canonical limb layout).
    """
    rows = np.asarray(rows, np.uint32)
    n = rows.shape[0]
    padded = np.zeros((n, 16 * spec.w), np.uint32)
    padded[:, 16 * spec.w - spec.k :] = rows
    padded = padded.reshape(n, spec.w, 16)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    return (padded << shifts).sum(axis=2, dtype=np.uint32)


def to_bases_batch_np(spec: KmerSpec, limbs: np.ndarray) -> np.ndarray:
    """Host-vectorized inverse of from_bases_batch_np: (N, W) -> (N, K)."""
    limbs = np.asarray(limbs, np.uint32)
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)
    all_b = ((limbs[:, :, None] >> shifts[None, None, :]) & 3).reshape(
        limbs.shape[0], -1
    )
    return all_b[:, 16 * spec.w - spec.k :].astype(np.uint8)


def from_int(spec: KmerSpec, value: int) -> np.ndarray:
    """Python int rank -> (W,) uint32 limbs (host).  kmer.rs from_u64 analog."""
    out = np.zeros(spec.w, dtype=np.uint32)
    for i in range(spec.w - 1, -1, -1):
        out[i] = value & 0xFFFFFFFF
        value >>= 32
    return out


def to_int(spec: KmerSpec, limbs) -> int:
    """(W,) limbs of one kmer -> its Python int rank (host).  Takes numpy
    uint32 limbs or the port's int64 limbs, as a tensor or an array."""
    if torch.is_tensor(limbs):
        limbs = limbs.cpu().numpy()
    limbs = np.asarray(limbs).astype(np.uint64)
    v = 0
    for i in range(spec.w):
        v = (v << 32) | int(limbs[..., i])
    return v


def from_bases(spec: KmerSpec, bases) -> np.ndarray:
    """Host: (K,) array of 2-bit codes -> (W,) limbs."""
    v = 0
    for b in np.asarray(bases, dtype=np.uint8)[: spec.k]:
        v = (v << 2) | int(b)
    return from_int(spec, v)


def to_bases(spec: KmerSpec, limbs) -> np.ndarray:
    """Host: (W,) limbs -> (K,) array of 2-bit codes."""
    v = to_int(spec, limbs)
    out = np.empty(spec.k, dtype=np.uint8)
    for i in range(spec.k - 1, -1, -1):
        out[i] = v & 3
        v >>= 2
    return out


def to_string(spec: KmerSpec, limbs) -> str:
    return "".join("ACGT"[b] for b in to_bases(spec, limbs))


def from_string(spec: KmerSpec, s: str) -> np.ndarray:
    return from_bases(spec, B.ascii_to_bases(s))


def kmers_from_bytes(spec: KmerSpec, bases) -> np.ndarray:
    """All kmers of a 2-bit coded array -> (N-K+1, W) limbs (lib.rs:288-305).

    Returns an empty (0, W) array when the input is shorter than K.
    """
    bases = np.asarray(bases, np.uint8)
    if len(bases) < spec.k:
        return np.zeros((0, spec.w), np.uint32)
    return from_bases_batch_np(spec, np.lib.stride_tricks.sliding_window_view(bases, spec.k))


def kmers_from_ascii(spec: KmerSpec, s) -> np.ndarray:
    """All kmers of an ASCII ACGT string (lib.rs:307-327)."""
    return kmers_from_bytes(spec, B.ascii_to_bases(s))


def to_torch(limbs_u32: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 limbs -> int64 limb tensor on ``device``."""
    return torch.from_numpy(np.asarray(limbs_u32, np.uint32).astype(np.int64)).to(device)


def to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> numpy uint32 limbs."""
    return limbs.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# elementwise kmer ops on (..., W) int64 tensors
# ---------------------------------------------------------------------------


def empty(spec: KmerSpec, shape=(), device="cuda") -> torch.Tensor:
    """All-A kmers on ``device``.  Kmer::empty (lib.rs:187)."""
    return torch.zeros((*shape, spec.w), dtype=torch.int64, device=device)


def mask_value(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    """Clear the padding bits above the 2K-bit value."""
    if spec.pad == 0:
        return a
    out = a.clone()
    out[..., 0] &= int(spec.top_mask)
    return out


def _apply_top_mask(spec: KmerSpec, limbs: list) -> list:
    if spec.pad:
        limbs[0] = limbs[0] & int(spec.top_mask)
    return limbs


def _split(a: torch.Tensor) -> list:
    return [a[..., i] for i in range(a.shape[-1])]


def extend_right(spec: KmerSpec, a: torch.Tensor, v) -> torch.Tensor:
    """Shift base ``v`` into the right end, dropping the leftmost base.

    Kmer::extend_right (lib.rs:207).  ``v``: int tensor of 0..3
    broadcastable to ``a[..., 0]``.
    """
    x = _split(a)
    out = []
    for i in range(spec.w):
        lo = (x[i + 1] >> 30) if i + 1 < spec.w else (torch.as_tensor(v, device=a.device) & 3)
        out.append(((x[i] << 2) & M32) | lo)
    return torch.stack(_apply_top_mask(spec, out), dim=-1)


def extend_left(spec: KmerSpec, a: torch.Tensor, v) -> torch.Tensor:
    """Shift base ``v`` into the left end, dropping the rightmost base.

    Kmer::extend_left (lib.rs:204).
    """
    x = _split(a)
    out = []
    for i in range(spec.w):
        hi = ((x[i - 1] << 30) & M32) if i > 0 else 0
        out.append((x[i] >> 2) | hi)
    shift = spec.nbits - 2
    il = spec.w - 1 - shift // 32
    out[il] = out[il] | (torch.as_tensor(v, device=a.device).to(torch.int64) << (shift % 32))
    return torch.stack(_apply_top_mask(spec, out), dim=-1)


def reverse_by_twos_u32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups within each 32-bit limb (kmer.rs:169-183)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0000FFFF) << 16) | ((x >> 16) & 0x0000FFFF)
    return x


def rc(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    """Reverse complement: complement within the value bits, reverse the
    2-bit groups of the whole 32W-bit register (per-limb reversal plus limb
    swap), then shift right by the pad to realign (IntKmer::rc)."""
    x = _split(a)
    comp = [x[i] ^ int(spec.limb_mask(i)) for i in range(spec.w)]
    rev = [reverse_by_twos_u32(comp[i]) for i in range(spec.w - 1, -1, -1)]
    if spec.pad:
        p, q = spec.pad, 32 - spec.pad
        out = []
        for i in range(spec.w):
            hi = ((rev[i - 1] << q) & M32) if i > 0 else 0
            out.append((rev[i] >> p) | hi)
    else:
        out = rev
    return torch.stack(_apply_top_mask(spec, out), dim=-1)


def extend(spec: KmerSpec, a: torch.Tensor, v, dir_is_right) -> torch.Tensor:
    """extend() with a direction flag per row (False = left, True = right)."""
    d = torch.as_tensor(dir_is_right, dtype=torch.bool, device=a.device)[..., None]
    return torch.where(d, extend_right(spec, a, v), extend_left(spec, a, v))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over limb vectors."""
    res = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eqs = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(a.shape[-1]):
        res = res | (eqs & (a[..., i] < b[..., i]))
        eqs = eqs & (a[..., i] == b[..., i])
    return res


def min_rc_flip(spec: KmerSpec, a: torch.Tensor):
    """Canonical form: (min(kmer, rc), flipped).  lib.rs:224-231.

    flipped is True when ``not (kmer < rc)``: palindromes report
    flipped=True with an unchanged value, as the reference does.
    """
    r = rc(spec, a)
    flip = ~lt(a, r)
    return torch.where(flip[..., None], r, a), flip


def min_rc(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    r = rc(spec, a)
    return torch.where(lt(a, r)[..., None], a, r)


def is_palindrome(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    """lib.rs:244-246: only even K can match its own rc."""
    if spec.k % 2 == 1:
        return torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    return eq(a, rc(spec, a))


def _limb_shift(spec: KmerSpec, pos: int):
    """(limb index, shift in the limb) of base ``pos`` (0 = leftmost)."""
    shift = spec.nbits - 2 - 2 * pos
    return spec.w - 1 - shift // 32, shift % 32


def get_base(spec: KmerSpec, a: torch.Tensor, pos: int) -> torch.Tensor:
    """Base at static position ``pos`` (0 = leftmost).  Mer::get."""
    il, sh = _limb_shift(spec, pos)
    return (a[..., il] >> sh) & 3


def set_base(spec: KmerSpec, a: torch.Tensor, pos: int, v) -> torch.Tensor:
    """A copy of ``a`` with the base at static position ``pos`` set to
    ``v`` (a 0..3 int or a tensor of ``a[..., 0]``'s shape).  Mer::set_mut."""
    il, sh = _limb_shift(spec, pos)
    out = a.clone()
    out[..., il] = (a[..., il] & ~(3 << sh)) | (torch.as_tensor(v, device=a.device).to(torch.int64) << sh)
    return out


def get_base_dyn(spec: KmerSpec, a: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Base at a position tensor ``pos`` (0 = leftmost) of the shape of
    ``a[..., 0]``; :func:`get_base` for a position that varies by row."""
    shift = spec.nbits - 2 - 2 * pos.to(torch.int64)
    il = spec.w - 1 - shift // 32
    limb = torch.take_along_dim(a, il[..., None], dim=-1)[..., 0]
    return (limb >> (shift % 32)) & 3


def first_base(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    return get_base(spec, a, 0)


def last_base(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    return get_base(spec, a, spec.k - 1)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 (SWAR; the product
    stays under 2^60, so it is masked back to 32 bits, not wrapped)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def hamming_dist(spec: KmerSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Number of differing bases, int64.  kmer.rs:405-409."""
    total = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(spec.w):
        d = a[..., i] ^ b[..., i]
        total += _popcount32((d | (d >> 1)) & 0x55555555)
    return total


def _count_mix(spec: KmerSpec, a: torch.Tensor, same: bool) -> torch.Tensor:
    """Bases whose two bits are equal (A/T, ``same``) or differ (G/C);
    ``limb_mask`` clears the pad bits, so zero padding never counts as A."""
    total = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(spec.w):
        v = a[..., i]
        mix = (v >> 1) ^ v
        if same:
            mix = ~mix
        total += _popcount32(mix & 0x55555555 & int(spec.limb_mask(i)))
    return total


def at_count(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    """Count of A/T bases, int64.  kmer.rs:354-360."""
    return _count_mix(spec, a, True)


def gc_count(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    """Count of G/C bases, int64.  kmer.rs:362-368."""
    return _count_mix(spec, a, False)


def hamming_neighbors(spec: KmerSpec, a: torch.Tensor):
    """Candidates for all Hamming-distance-1 neighbors of each kmer
    (neighbors.rs:4-52, vectorized).

    Returns ``(cands (..., 4K, W), mask (..., 4K))``: one candidate per
    (position, base), position-major and base-ascending, with ``mask``
    False where the base is the original one, so 3K entries a kmer are
    True: the reference iterator's output, in its order.  Elementwise: at
    (n, 4K, W) int64 a caller on a large table runs it in chunks.
    """
    outs, masks = [], []
    for pos in range(spec.k):
        cur = get_base(spec, a, pos)
        for b in range(4):
            outs.append(set_base(spec, a, pos, b))
            masks.append(cur != b)
    return torch.stack(outs, dim=-2), torch.stack(masks, dim=-1)
