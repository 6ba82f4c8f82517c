"""Linked-read simulator — drives tests, benches, and the crib evaluation.

The reference validates itself on real 10x lanes plus the crib truth mechanism
(SURVEY.md §5); with no data shipped in this environment, the framework carries a
deterministic simulator of the 10x generative process (SURVEY.md §1): a genome (or
two haplotypes), per-barcode pools of long molecules, short reads sampled from the
molecules.  Ground truth (molecule of origin per read) is returned so clustering
purity can be scored exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .fastq import ReadBatch

__all__ = ["SimConfig", "SimResult", "simulate", "random_genome"]


@dataclass
class SimConfig:
    genome_len: int = 200_000
    n_barcodes: int = 64
    molecules_per_barcode: int = 4
    molecule_len: int = 20_000
    reads_per_molecule: int = 50
    read_len: int = 150
    error_rate: float = 0.0
    het_rate: float = 0.0          # if > 0, generate two haplotypes differing at this rate
    seed: int = 0


@dataclass
class SimResult:
    reads: ReadBatch               # codes include per-read barcodes already split out
    barcode_keys: np.ndarray       # (N,) u32 per read
    truth_molecule: np.ndarray     # (N,) int32 global molecule id per read
    truth_span: np.ndarray         # (M, 3) int32: (haplotype, start, end) per molecule
    genome: np.ndarray             # (G,) uint8 hap0
    genome_hap1: Optional[np.ndarray] = None


def random_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n).astype(np.uint8)


def simulate(cfg: SimConfig) -> SimResult:
    rng = np.random.default_rng(cfg.seed)
    g0 = random_genome(rng, cfg.genome_len)
    g1 = None
    if cfg.het_rate > 0:
        g1 = g0.copy()
        sites = rng.random(cfg.genome_len) < cfg.het_rate
        shift = rng.integers(1, 4, size=cfg.genome_len).astype(np.uint8)
        g1[sites] = (g1[sites] + shift[sites]) % 4
    haps = [g0] if g1 is None else [g0, g1]

    n_mol = cfg.n_barcodes * cfg.molecules_per_barcode
    rpm = cfg.reads_per_molecule
    n_reads = n_mol * rpm
    # distinct random 16bp barcodes
    bc_keys = rng.choice(1 << 32, size=cfg.n_barcodes, replace=False).astype(np.uint32)

    mol_len = min(cfg.molecule_len, cfg.genome_len)
    # fully vectorized sampling (the scalar loop took minutes at lane scale)
    hap_of_mol = rng.integers(0, len(haps), size=n_mol).astype(np.int32)
    mol_start = rng.integers(0, cfg.genome_len - mol_len + 1,
                             size=n_mol).astype(np.int64)
    spans = np.stack([hap_of_mol, mol_start.astype(np.int32),
                      (mol_start + mol_len).astype(np.int32)], axis=1)

    read_off = rng.integers(0, mol_len - cfg.read_len + 1,
                            size=(n_mol, rpm)).astype(np.int64)
    read_start = (mol_start[:, None] + read_off).reshape(-1)
    win = read_start[:, None] + np.arange(cfg.read_len)
    stacked = np.stack(haps)                                  # (n_haps, G)
    codes = stacked[np.repeat(hap_of_mol, rpm)[:, None], win].astype(np.uint8)
    if cfg.error_rate > 0:
        errs = rng.random(codes.shape) < cfg.error_rate
        shift = rng.integers(1, 4, size=codes.shape).astype(np.uint8)
        codes = np.where(errs, (codes + shift) % 4, codes)

    truth_mol = np.repeat(np.arange(n_mol, dtype=np.int32), rpm)
    read_bc = bc_keys[np.repeat(np.arange(n_mol) // cfg.molecules_per_barcode, rpm)]
    lengths = np.full(n_reads, cfg.read_len, np.int32)
    batch = ReadBatch(codes=codes, lengths=lengths, barcodes=read_bc)
    return SimResult(reads=batch, barcode_keys=read_bc, truth_molecule=truth_mol,
                     truth_span=spans, genome=g0, genome_hap1=g1)
