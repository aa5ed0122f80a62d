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


def to_torch(limbs_u32: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 limbs -> int64 limb tensor on ``device``."""
    return torch.from_numpy(np.asarray(limbs_u32, np.uint32).astype(np.int64)).to(device)


def to_numpy(limbs: torch.Tensor) -> np.ndarray:
    """int64 limb tensor -> numpy uint32 limbs."""
    return limbs.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# elementwise kmer ops on (..., W) int64 tensors
# ---------------------------------------------------------------------------


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


def is_palindrome(spec: KmerSpec, a: torch.Tensor) -> torch.Tensor:
    """lib.rs:244-246: only even K can match its own rc."""
    if spec.k % 2 == 1:
        return torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    return eq(a, rc(spec, a))


def get_base(spec: KmerSpec, a: torch.Tensor, pos: int) -> torch.Tensor:
    """Base at static position ``pos`` (0 = leftmost).  Mer::get."""
    shift = spec.nbits - 2 - 2 * pos
    il = spec.w - 1 - shift // 32
    return (a[..., il] >> (shift % 32)) & 3


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
