"""The lanes the benchmark runs: a frozen copy of the blocked lane generator
(``blocked_genome`` and ``make_barcodes_lane_blocked`` of the port's
``bench.py``), with the molecule length as a parameter.

Each of ``n_codes`` barcodes holds one molecule of ``molecule`` bases drawn
from a random genome, and ``n_reads / n_codes`` reads of ``read_len`` bases
drawn inside it; reads come sorted by barcode.  The genome is drawn in
fixed blocks of ``GENOME_BLOCK`` bases from ``default_rng([seed, 1, i])``,
and the molecule starts and read offsets from ``default_rng([seed, 0])``,
so the lane is a fixed function of the seed and the sizes.  Reads are
2-bit packed (base j at bits 2j of word j // 16) ``chunk`` at a time,
which bounds host memory and does not change the bytes.

Sequencing is drawn from ``default_rng([seed, 2])``, for the whole lane at
once: with ``both_strands`` each read is read off either strand (reverse
complemented with probability 1/2), and each base is substituted by one of
the three others with probability ``error_rate``.  With neither, the lane is
the port's generator's, byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Lane", "blocked_genome", "make_lane", "lane_of", "GENOME_BLOCK"]

GENOME_BLOCK = 1 << 24   # bases drawn per seed of the genome
READ_CHUNK = 1 << 17     # reads gathered and packed at once


@dataclass
class Lane:
    packed: np.ndarray       # (n_reads, words) uint32
    lengths: np.ndarray      # (n_reads,) int32
    barcode_ids: np.ndarray  # (n_reads,) int32, ascending
    n_codes: int
    read_len: int

    @property
    def n_reads(self) -> int:
        return self.packed.shape[0]


def blocked_genome(genome_len: int, seed: int) -> np.ndarray:
    """A random genome as uint8 base codes: block i is four 2-bit bases per
    byte of ``default_rng([seed, 1, i]).bytes``."""
    genome = np.empty(genome_len, np.uint8)
    for i, a in enumerate(range(0, genome_len, GENOME_BLOCK)):
        n = min(GENOME_BLOCK, genome_len - a)
        raw = np.frombuffer(np.random.default_rng([seed, 1, i])
                            .bytes((n + 3) // 4), np.uint8)
        bases = genome[a:a + n]
        for j in range(4):
            part = bases[j::4]
            np.bitwise_and(raw[:len(part)] >> (2 * j), 3, out=part)
    return genome


def _sequencing(n_reads: int, read_len: int, seed: int, error_rate: float,
                both_strands: bool):
    """(reverse-complemented reads (n_reads,) bool, substituted positions
    in the lane's bases read by read (E,) int64 ascending, their shifts
    (E,) uint8 in 1..3)."""
    rng = np.random.default_rng([seed, 2])
    flip = (rng.random(n_reads) < 0.5 if both_strands
            else np.zeros(n_reads, bool))
    total = n_reads * read_len
    pos = np.zeros(0, np.int64)
    if error_rate > 0:
        parts, at = [], -1
        while at < total:
            n = int(total * error_rate * 1.05) + 1024
            gaps = np.cumsum(rng.geometric(error_rate, n), dtype=np.int64)
            parts.append(at + gaps)
            at = int(parts[-1][-1])
        pos = np.concatenate(parts)
        pos = pos[pos < total]
    shift = rng.integers(1, 4, pos.shape[0], dtype=np.uint8)
    return flip, pos, shift


def make_lane(n_reads: int, n_codes: int, genome_len: int, seed: int,
              molecule: int = 30_000, read_len: int = 150,
              error_rate: float = 0.0, both_strands: bool = False,
              chunk: int = READ_CHUNK) -> Lane:
    """The lane of the module docstring."""
    if n_reads % n_codes:
        raise ValueError("n_reads must be a multiple of n_codes")
    if not read_len < molecule < genome_len:
        raise ValueError("need read_len < molecule < genome_len")
    genome = blocked_genome(genome_len, seed)
    rng = np.random.default_rng([seed, 0])
    mol_starts = rng.integers(0, genome_len - molecule, size=n_codes)
    offs = rng.integers(0, molecule - read_len, size=n_reads, dtype=np.int32)
    bc_ids = np.repeat(np.arange(n_codes, dtype=np.int32), n_reads // n_codes)
    words = (read_len + 15) // 16
    packed = np.empty((n_reads, words), np.uint32)
    window = np.lib.stride_tricks.sliding_window_view(genome, read_len)
    flip, err_pos, err_shift = _sequencing(n_reads, read_len, seed,
                                           error_rate, both_strands)
    padded = np.zeros((chunk, 16 * words), np.uint8)
    for a in range(0, n_reads, chunk):
        b = min(a + chunk, n_reads)
        reads = padded[:b - a]
        reads[:, :read_len] = window[mol_starts[bc_ids[a:b]] + offs[a:b]]
        rc = np.flatnonzero(flip[a:b])
        reads[rc, :read_len] = 3 - reads[rc, read_len - 1::-1]
        e0, e1 = np.searchsorted(err_pos, [a * read_len, b * read_len])
        r, c = np.divmod(err_pos[e0:e1] - a * read_len, read_len)
        reads[r, c] = (reads[r, c] + err_shift[e0:e1]) & 3
        # four bases per byte, the bytes read as little-endian uint32 words
        q = reads.reshape(b - a, 4 * words, 4)
        byte = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) \
            | (q[..., 3] << 6)
        packed[a:b] = byte.view("<u4")
    return Lane(packed=packed, lengths=np.full(n_reads, read_len, np.int32),
                barcode_ids=bc_ids, n_codes=n_codes, read_len=read_len)


# configuration keys and the make_lane arguments they set
LANE_KEYS = {"n_reads": "n_reads", "n_barcodes": "n_codes",
             "genome_len": "genome_len", "molecule_len": "molecule",
             "read_len": "read_len", "error_rate": "error_rate",
             "both_strands": "both_strands"}


def lane_of(cfg: dict, seed: int) -> Lane:
    """The lane of configuration ``cfg`` drawn from ``seed`` (any whole
    number: taken modulo 2**64)."""
    return make_lane(seed=seed % (1 << 64),
                     **{arg: cfg[k] for k, arg in LANE_KEYS.items()
                        if k in cfg})
