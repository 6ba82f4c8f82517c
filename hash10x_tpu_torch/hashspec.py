"""Seqhash parameterization — the bit-compat keystone of the framework.

Models the reference's ``Seqhash`` object (``seqhash.c:~seqhashCreate``, reconstructed
— SURVEY.md §3.1 #4, confidence [H] for the API, [M] for exact constants; the reference
mount was empty, so the arithmetic below is the documented contract of THIS framework
and is built to be swappable the moment the C source becomes readable).

Reconstructed reference arithmetic (all mod 2^64):

* 2-bit base codes a=0 c=1 g=2 t=3 (``dna2indexConv``).
* ``mask = (1 << 2k) - 1``
* ``srandom(seed)`` then
  ``factor1 = (random() << 32) | random() | 1``; ``shift1 = 64 - 2k``;
  ``factor2 = (random() << 32) | random() | 1``; ``shift2 = 2k``.
* ``patternRC[b] = (3 - b) << 2(k-1)`` — the complement of ``b`` pre-shifted to the
  top base position of a k-mer code.
* forward roll:  ``h   = ((h << 2) | b) & mask``
* reverse roll:  ``hRC = (hRC >> 2) | patternRC[b]``
* ``hashFunc(x) = (x * factor1 mod 2^64) >> shift1``  (a 2k-bit value)
* canonical hash of a k-mer = ``min(hashFunc(h), hashFunc(hRC))``; the k-mer is
  "forward" iff ``hashFunc(h) < hashFunc(hRC)`` (ties break to reverse, matching the
  reference's ``if (hashF < hashR)``).

Sketch modes built on the canonical hash stream:

* ``kmer``  — every k-mer (``seqhashRCiterator``).
* ``minimizer`` — leftmost-minimum of each window of ``w`` consecutive k-mer hashes;
  the minimizer set of a sequence is the union over windows, each position emitted
  once, in position order (``minimizerIterator``).
* ``modimizer`` — k-mers whose canonical hash satisfies ``hash % m == 0`` with
  ``m = w`` by default (``modIterator``; reconstructed semantics, [M]).
* ``syncmer`` — extension (not load-bearing for hash10x parity): open syncmer — the
  k-mer is kept iff the minimal s-mer hash inside it sits at offset 0.
"""

from __future__ import annotations

import dataclasses
import json

from .glibc_random import GlibcRandom

__all__ = ["HashSpec", "U64MAX"]

U64MAX = (1 << 64) - 1
_M64 = U64MAX


@dataclasses.dataclass(frozen=True)
class HashSpec:
    """Frozen seqhash parameter set. Equality of all fields is required for two hash
    tables to be comparable (the reference serializes these into the ``.hash`` header
    — ``seqhashWrite/Read``, SURVEY.md §3.1 #4)."""

    k: int = 21
    w: int = 1
    seed: int = 7

    # Derived, filled in __post_init__ from the glibc stream.
    mask: int = dataclasses.field(default=0, compare=False)
    shift1: int = dataclasses.field(default=0, compare=False)
    factor1: int = dataclasses.field(default=0, compare=False)
    shift2: int = dataclasses.field(default=0, compare=False)
    factor2: int = dataclasses.field(default=0, compare=False)
    pattern_rc: tuple = dataclasses.field(default=(), compare=False)

    def __post_init__(self):
        if not (1 <= self.k < 32):
            raise ValueError(f"k must be in [1, 31], got {self.k}")
        if self.w < 1:
            raise ValueError(f"w must be >= 1, got {self.w}")
        rng = GlibcRandom(self.seed)
        factor1 = ((rng.random() << 32) | rng.random() | 1) & _M64
        factor2 = ((rng.random() << 32) | rng.random() | 1) & _M64
        object.__setattr__(self, "mask", (1 << (2 * self.k)) - 1)
        object.__setattr__(self, "shift1", 64 - 2 * self.k)
        object.__setattr__(self, "factor1", factor1)
        object.__setattr__(self, "shift2", 2 * self.k)
        object.__setattr__(self, "factor2", factor2)
        object.__setattr__(
            self, "pattern_rc", tuple((3 - b) << (2 * (self.k - 1)) for b in range(4))
        )

    # -- scalar reference arithmetic (the torch plain path and the CUDA kernel
    #    reproduce these bit-for-bit) -------------------------------------------------

    def hash_func(self, x: int) -> int:
        return ((x * self.factor1) & _M64) >> self.shift1

    def canonical(self, h: int, h_rc: int) -> tuple:
        """Return (hash, is_forward) for a k-mer given fwd/RC 2k-bit codes."""
        hf = self.hash_func(h)
        hr = self.hash_func(h_rc)
        if hf < hr:
            return hf, True
        return hr, False

    # -- (de)serialization — the `.hash` header contract ----------------------------

    def to_json(self) -> str:
        return json.dumps({"k": self.k, "w": self.w, "seed": self.seed})

    @classmethod
    def from_json(cls, s: str) -> "HashSpec":
        d = json.loads(s)
        return cls(k=int(d["k"]), w=int(d["w"]), seed=int(d["seed"]))
