"""Canonical k-mer hashes and w-window minimizers of packed reads, in plain
torch, from a frozen copy of the seqhash rules.

* ``srandom(seed)`` then ``factor1 = (random() << 32) | random() | 1``
  (glibc's TYPE_3 generator, :func:`glibc_random`).
* Bases are 2-bit codes a=0 c=1 g=2 t=3.  The forward code of the k-mer at
  position p is ``sum_j b[p+j] << 2(k-1-j)``; its reverse complement's is
  ``sum_j (3 - b[p+j]) << 2j``.
* ``hash(x) = ((x * factor1) mod 2^64) >> (64 - 2k)``, and a k-mer's hash is
  the smaller of its two codes' hashes.
* A position is a minimizer when its hash is the leftmost minimum of some
  window of w consecutive positions; each position is emitted once.

Only reads of one full length with no N are taken (what the benchmark's
lanes hold); anything else raises.
"""

from __future__ import annotations

import torch

__all__ = ["glibc_random", "hash_factor", "unpack", "minimizers"]

_MOD = 2147483647
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def glibc_random(seed: int, n: int) -> list:
    """The first ``n`` outputs of glibc ``random()`` after ``srandom(seed)``:
    r[0] = seed (0 taken as 1), r[i] = 16807 r[i-1] mod (2^31 - 1) by
    Schrage's step on a signed 32-bit word for i < 31, r[i] = r[i-31] for
    i < 34, then r[i] = r[i-31] + r[i-3] mod 2^32; the first 310 sums are
    dropped and each later one is shifted right by one bit."""
    seed &= _M32
    word = seed or 1
    if word >= 1 << 31:
        word -= 1 << 32
    r = [word & _M32]
    for _ in range(1, 31):
        hi = int(word / 127773)   # C division: toward zero
        word = 16807 * (word - hi * 127773) - 2836 * hi
        if word < 0:
            word += _MOD
        r.append(word & _M32)
    r += r[:3]
    out = []
    while len(out) < n:
        r.append((r[-31] + r[-3]) & _M32)
        if len(r) > 344:
            out.append(r[-1] >> 1)
    return out


def hash_factor(seed: int) -> int:
    """``factor1`` of the seqhash of ``seed``."""
    a, b = glibc_random(seed, 2)
    return ((a << 32) | b | 1) & _M64


def unpack(packed: torch.Tensor, read_len: int) -> torch.Tensor:
    """(n, words) int32 words -> (n, read_len) int64 base codes."""
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & _M32
    codes = (words[:, :, None] >> shifts) & 3
    return codes.reshape(packed.shape[0], -1)[:, :read_len]


def _sliding_min(x: torch.Tensor, w: int) -> torch.Tensor:
    """out[:, i] = min(x[:, i:i+w]) for every window inside the row, by
    doubling: windows of 1, 2, 4, ... and two overlapping ones for w."""
    span, m = 1, x
    while 2 * span <= w:
        m = torch.minimum(m[:, :-span], m[:, span:])
        span *= 2
    if span < w:
        m = torch.minimum(m[:, :m.shape[1] - (w - span)], m[:, w - span:])
    return m


def minimizers(packed: torch.Tensor, read_len: int, k: int, w: int,
               factor: int):
    """Minimizers of every read: (hashes (n, P) int64, emitted (n, P) bool)
    with P = read_len - k + 1 positions."""
    P = read_len - k + 1
    if P < w or not 1 <= k <= 31:
        raise ValueError("reads must hold a whole window; 1 <= k <= 31")
    b = unpack(packed, read_len)
    fwd = torch.zeros((b.shape[0], P), dtype=torch.int64, device=b.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | b[:, j:j + P]
        rc |= (3 - b[:, j:j + P]) << (2 * j)
    f = factor - (1 << 64) if factor >= 1 << 63 else factor
    keep = (1 << (2 * k)) - 1
    # int64 products wrap mod 2^64; the arithmetic shift is made logical by
    # the mask
    hf = ((fwd * f) >> (64 - 2 * k)) & keep
    hr = ((rc * f) >> (64 - 2 * k)) & keep
    h = torch.minimum(hf, hr)
    # each window's leftmost minimum: the smallest offset holding it
    m = _sliding_min(h, w)
    S = m.shape[1]
    start = torch.arange(S, dtype=torch.int64, device=b.device)
    best = torch.zeros_like(m)
    for o in reversed(range(w)):
        best = torch.where(h[:, o:o + S] == m, start + o, best)
    emitted = torch.zeros_like(h, dtype=torch.bool)
    emitted.scatter_(1, best, True)
    return h, emitted
