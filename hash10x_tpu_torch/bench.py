"""The lanes the port's tests and ``chip_smoke.py`` run on.

* ``make_lane``, ``make_barcodes_lane`` and ``synth_incidence``: the
  config-#1 lane, the 800k-read / 50k-barcode lane and the synthesized
  incidence of the JAX package's top-level ``bench.py``, with its seeds
  and constants.
* ``make_barcodes_lane_blocked``: the barcodes lane's shape at any scale
  (lane20x by default), built a block at a time, with its genome and SNP
  helpers ``blocked_genome`` and ``blocked_snps``.
* ``write_fasta_records``: a genome as FASTA records.

The port is measured by the ``benchmark/`` harness
(``python3 -m benchmark.run --workload <cell>``), not here.
"""

from __future__ import annotations

import numpy as np

from .io.fqb import Fqb

__all__ = ["make_lane", "make_barcodes_lane", "blocked_genome",
           "blocked_snps", "make_barcodes_lane_blocked",
           "write_fasta_records", "synth_incidence"]

# the JAX package's bench.py constants
N_READS = 1 << 18
READ_LEN = 150
BATCH = 1 << 12
K, W, SEED = 21, 11, 17
C_SUBSET = 1 << 14
BC_READS, BC_CODES = 800_000, 50_000
BC_GENOME = 100_000_000
MOLECULE = 30_000


def make_lane(n_reads: int = N_READS) -> np.ndarray:
    """Config #1: reads of a 2 Mb random genome (seed 7)."""
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=2_000_000).astype(np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n_reads)
    return genome[starts[:, None] + np.arange(READ_LEN)]


def make_barcodes_lane(n_reads: int = BC_READS, n_codes: int = BC_CODES,
                       genome_len: int = BC_GENOME):
    """Config-#3 scale (seed 11): each barcode one 30 kb molecule of a
    random genome, its n_reads / n_codes reads drawn inside it.  Returns
    (reads (n, 150) uint8, barcode ids (n,) int32)."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    mol_starts = rng.integers(0, len(genome) - MOLECULE, size=n_codes)
    bc_ids = np.repeat(np.arange(n_codes, dtype=np.int32), n_reads // n_codes)
    offs = rng.integers(0, MOLECULE - READ_LEN, size=n_reads)
    starts = mol_starts[bc_ids] + offs
    return genome[starts[:, None] + np.arange(READ_LEN)], bc_ids


LANE20X = (16_000_000, 1_000_000, 2_000_000_000)   # reads, barcodes, genome
GENOME_BLOCK = 1 << 24   # bases drawn per seed of the blocked genome
READ_CHUNK = 1 << 17     # reads gathered and packed at once


def blocked_genome(genome_len: int, seed: int = 11) -> np.ndarray:
    """A random genome as uint8 base codes, drawn in fixed blocks of
    ``GENOME_BLOCK`` bases: block i is four 2-bit bases per byte of
    ``default_rng([seed, 1, i]).bytes``, so no temporary is wider than a
    block and the bases are a fixed function of the seed."""
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


def blocked_snps(genome: np.ndarray, het_rate: float,
                 seed: int = 11) -> np.ndarray:
    """A second haplotype of ``genome``: a copy with a SNP at each base with
    probability ``het_rate``, drawn per ``GENOME_BLOCK``-base block from
    ``default_rng([seed, 2, i])``: the block's site count (binomial), the
    sites (uniform without replacement), then a shift of 1-3 per site."""
    hap = genome.copy()
    for i, a in enumerate(range(0, len(genome), GENOME_BLOCK)):
        n = min(GENOME_BLOCK, len(genome) - a)
        rng = np.random.default_rng([seed, 2, i])
        sites = a + np.sort(rng.choice(n, rng.binomial(n, het_rate),
                                       replace=False))
        shift = rng.integers(1, 4, size=len(sites), dtype=np.uint8)
        hap[sites] = (hap[sites] + shift) % 4
    return hap


def make_barcodes_lane_blocked(n_reads: int = LANE20X[0],
                               n_codes: int = LANE20X[1],
                               genome_len: int = LANE20X[2], seed: int = 11,
                               chunk: int = READ_CHUNK, het_rate: float = 0.0,
                               return_haplotypes: bool = False):
    """The bench lane's shape at any scale, built a block at a time: each
    of ``n_codes`` barcodes is one 30 kb molecule of a
    :func:`blocked_genome` with ``n_reads / n_codes`` 150 bp reads drawn
    inside it; reads come sorted by barcode.  Reads are gathered and 2-bit
    packed ``chunk`` at a time (a memory bound only: the output does not
    depend on it), so host memory holds the genome, the packed lane and
    one chunk.  Its random stream is not ``make_barcodes_lane``'s.

    With ``het_rate`` > 0 the sample is diploid: the second haplotype is
    :func:`blocked_snps` of the genome, and each molecule takes its reads
    from the haplotype ``default_rng([seed, 3])`` draws for it; at 0 no
    draw is made and the lane's bytes are the haploid lane's.  With
    ``return_haplotypes`` returns (Fqb, [haplotypes]) instead of the Fqb."""
    if n_reads % n_codes:
        raise ValueError("n_reads must be a multiple of n_codes")
    genome = blocked_genome(genome_len, seed)
    haps = [genome]
    if het_rate > 0:
        haps.append(blocked_snps(genome, het_rate, seed))
    rng = np.random.default_rng([seed, 0])
    mol_starts = rng.integers(0, genome_len - MOLECULE, size=n_codes)
    offs = rng.integers(0, MOLECULE - READ_LEN, size=n_reads,
                        dtype=np.int32)
    bc_ids = np.repeat(np.arange(n_codes, dtype=np.int32),
                       n_reads // n_codes)
    hap_of_mol = (np.random.default_rng([seed, 3]).integers(
        0, 2, size=n_codes) if het_rate > 0 else None)
    words = (READ_LEN + 15) // 16
    packed = np.empty((n_reads, words), np.uint32)
    windows = [np.lib.stride_tricks.sliding_window_view(h, READ_LEN)
               for h in haps]
    padded = np.zeros((chunk, 16 * words), np.uint8)
    for a in range(0, n_reads, chunk):
        b = min(a + chunk, n_reads)
        starts = mol_starts[bc_ids[a:b]] + offs[a:b]
        reads = padded[:b - a]
        reads[:, :READ_LEN] = windows[0][starts]
        if hap_of_mol is not None:
            on2 = np.flatnonzero(hap_of_mol[bc_ids[a:b]] == 1)
            reads[on2, :READ_LEN] = windows[1][starts[on2]]
        # pack_2bit's layout (base j at bits 2j of word j // 16), four
        # bases per byte, the bytes read as little-endian uint32 words
        q = reads.reshape(b - a, 4 * words, 4)
        byte = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) \
            | (q[..., 3] << 6)
        packed[a:b] = byte.view("<u4")
    fqb = Fqb(packed=packed, lengths=np.full(n_reads, READ_LEN, np.int32),
              barcode_ids=bc_ids,
              barcode_keys=np.arange(n_codes, dtype=np.uint32),
              read_len=READ_LEN)
    return (fqb, haps) if return_haplotypes else fqb


_ASCII = b"ACGT" + b"N" * 252   # base code -> letter, for bytes.translate


def write_fasta_records(path, genome: np.ndarray, n_records: int,
                        width: int = 60) -> None:
    """``genome`` (base codes) as ``n_records`` FASTA records of equal
    length (``chr1``, ``chr2``, ...; the last takes the remainder), as an
    assembly splits into chromosomes, ``width`` bases a line."""
    step = len(genome) // n_records
    with open(path, "wb") as f:
        for r in range(n_records):
            end = len(genome) if r == n_records - 1 else (r + 1) * step
            seq = np.frombuffer(genome[r * step:end].tobytes().translate(
                _ASCII), np.uint8)
            full = len(seq) // width * width
            body = np.empty((full // width, width + 1), np.uint8)
            body[:, :width] = seq[:full].reshape(-1, width)
            body[:, width] = ord("\n")
            f.write(b">chr%d\n" % (r + 1))
            f.write(body.data)
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")


def synth_incidence(n_codes: int, n_kmers: int, per_code: int):
    """bench.py's synthesized incidence (seed 5): each code holds
    ``per_code`` k-mers drawn from two 64-wide spans.  Returns flat
    (k-mer ids, code ids)."""
    rng = np.random.default_rng(5)
    spans = rng.integers(0, n_kmers - 64, size=(n_codes, 2))
    ks, cs = [], []
    for j in range(2):
        offs = rng.integers(0, 64, size=(n_codes, per_code // 2))
        ks.append((spans[:, j:j + 1] + offs).reshape(-1))
        cs.append(np.repeat(np.arange(n_codes), per_code // 2))
    return np.concatenate(ks), np.concatenate(cs)
