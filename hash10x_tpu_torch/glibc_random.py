"""Bit-exact replication of glibc's ``srandom``/``random`` (TYPE_3 generator).

Why this exists
---------------
The reference (``seqhash.c:~seqhashCreate``, reconstructed — see SURVEY.md §0/§3.1 #4)
derives its 64-bit multiplicative mixing constants from the C library PRNG::

    srandom (seed) ;
    sh->factor1 = (random() << 32) | random() | 0x01 ;
    ...
    sh->factor2 = (random() << 32) | random() | 0x01 ;

Bit-identical k-mer hashes therefore require reproducing glibc's ``random()`` stream
exactly.  glibc's default is the TYPE_3 additive-feedback generator over the trinomial
x^31 + x^3 + 1 with a 34-word state table and 310 warm-up discards.

Algorithm (public, documented in glibc's stdlib/random_r.c):

1. ``r[0] = seed`` (a seed of 0 is replaced by 1).
2. For i in 1..30:  ``r[i] = (16807 * r[i-1]) mod 2147483647`` computed via Schrage's
   method on signed 32-bit words (so intermediate negatives are wrapped by adding
   2^31-1).
3. For i in 31..33: ``r[i] = r[i-31]``.
4. The sequence continues additively mod 2^32: ``r[i] = r[i-31] + r[i-3]``.
5. The first 310 additive results are discarded; subsequent results, shifted right by
   one bit (``>> 1``), are the outputs of ``random()``.

Verified bit-exact against a gcc-compiled probe of the real glibc in
``tests/test_glibc_random.py``.
"""

from __future__ import annotations

__all__ = ["GlibcRandom"]

_MOD = 2147483647  # 2^31 - 1
_MASK32 = 0xFFFFFFFF


class GlibcRandom:
    """Stream-compatible model of glibc ``random()`` after ``srandom(seed)``."""

    def __init__(self, seed: int):
        seed = seed & _MASK32
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed
        # glibc holds the seed in an int32_t and uses C (truncating) division in
        # Schrage's step, so seeds >= 2^31 go negative here. Reproduce exactly.
        word = seed - (1 << 32) if seed >= (1 << 31) else seed
        for i in range(1, 31):
            hi = int(word / 127773)  # trunc toward zero, like C
            lo = word - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += _MOD
            r[i] = word & _MASK32
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._f = 0  # feedback tap index (i-31)
        self._idx = 3  # current index (i-3 lag is idx-3 handled via ring below)
        # glibc keeps two pointers into a 34-word ring: fptr starts at word 2+1=3? The
        # cleanest faithful formulation is the linear recurrence below with 310 discards.
        self._hist = list(r)  # full history; O(1) via ring would be fine, clarity first
        self._i = 34
        for _ in range(310):
            self._step()

    def _step(self) -> int:
        h = self._hist
        i = self._i
        v = (h[i - 31] + h[i - 3]) & _MASK32
        h.append(v)
        self._i += 1
        if len(h) > 4096:  # keep memory bounded; only the last 31 words matter
            del h[:-40]
            self._i = len(h)
        return v

    def random(self) -> int:
        """Next output of glibc ``random()`` — a value in [0, 2^31-1]."""
        return self._step() >> 1
