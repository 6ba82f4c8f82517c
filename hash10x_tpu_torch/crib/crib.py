"""Crib (ground-truth) evaluation: label table k-mers from haplotype
assemblies — the port of ``hash10x_tpu/crib/crib.py``.

Models the reference's crib mechanism (``hash10x.c:~cribBuild`` + crib
report, SURVEY.md §3.1 #10): hash every genome k-mer of one or two haplotype
FASTAs of the same sample, look each up in the retained table, and label
table k-mers HOM (single-copy in both haplotypes) / HET1 / HET2 (single-copy
in exactly one) / MUL (multi-copy) / ERR (absent from both), so cluster
purity and haplotype phasing can be scored.

Genome hashing runs through the sketch kernel's dense kmer mode
(``kernels.minimizer.sketch``): sequences stream in rows of ``_CHUNK`` bases
with a k - 1 overlap, so every genome k-mer is hashed in exactly one row.
On a CUDA device a row group is as tall as the genome allows (``_ROWS``),
so a haplotype takes few launches of the kernel and of the lookup around
it; results do not depend on the height.
The lookup is a ``searchsorted`` against the sorted retained keys, and the
multiplicity and first position of each retained k-mer accumulate on the
device.  ``Crib`` holds host numpy arrays and ``crib_report`` is host numpy,
as in the JAX package.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .. import INT64_MAX
from ..core.encode import ascii_to_codes
from ..hashspec import HashSpec
from ..io.fastq import fasta_records
from ..kernels import minimizer

__all__ = ["Crib", "build_crib", "crib_report", "genome_kmer_counts",
           "HOM", "HET1", "HET2", "MUL", "ERR", "LABEL_NAMES"]

HOM, HET1, HET2, MUL, ERR = 0, 1, 2, 3, 4
LABEL_NAMES = ("HOM", "HET1", "HET2", "MUL", "ERR")

_CHUNK = 1 << 15
# rows per kernel launch.  The CUDA kernel gives each ~1,000-position tile of
# a row its own warp, so a few hundred rows already fill the card; the
# height is kept at 4,096 so that a 100 Mb haplotype (~3,100 rows) is one
# launch of the kernel and of the lookup and scatters after it.  The CPU's
# plain version holds a few int64 (rows, _CHUNK) temporaries, so it takes few.
_ROWS = {"cuda": 4096, "cpu": 32}


@dataclass
class Crib:
    labels: np.ndarray        # (n_kmers,) uint8
    hap_counts: np.ndarray    # (n_haps, n_kmers) uint32 genome multiplicity
    n_haps: int
    positions: np.ndarray = None  # (n_kmers,) int64 hap1 first position in the
    #                               concatenated-genome coordinate, -1 absent
    rec_starts: np.ndarray = None  # (n_records,) int64 concatenated-coordinate
    #                                start of each hap1 FASTA record
    rec_names: List[str] = None    # hap1 FASTA record (chromosome) names

    def composition(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=5)

    def chrom_of(self, pos: np.ndarray) -> np.ndarray:
        """Record index of each concatenated-coordinate position (-1 for
        pos < 0).  Record == chromosome for assembly FASTAs."""
        if self.rec_starts is None or not len(self.rec_starts):
            return np.full(len(pos), -1, np.int64)
        c = np.searchsorted(self.rec_starts, pos, side="right") - 1
        return np.where(np.asarray(pos) >= 0, c, -1)


def _scan_group(spec: HashSpec, counts, first_pos, rows, lens, offs,
                retained) -> None:
    """Hash one row group in the sketch's dense kmer mode, look every valid
    hash up in the retained keys, and add its multiplicity and first
    position into the accumulators.  A miss adds the neutral values (0 and
    ``INT64_MAX``) at its insertion point, so misses, the bulk of a genome,
    spread over the table instead of queueing on one dropped slot."""
    h, _, valid, _ = minimizer.sketch(spec, rows, lens, mode="kmer")
    flat = h.reshape(-1)
    n = retained.shape[0]
    idx = torch.clamp(torch.searchsorted(retained, flat), max=n - 1)
    hit = (retained[idx] == flat) & valid.reshape(-1)
    counts.scatter_add_(0, idx, hit.to(torch.int64))
    P = h.shape[1]
    pos = (offs[:, None] + torch.arange(P, device=h.device)).reshape(-1)
    first_pos.scatter_reduce_(0, idx, torch.where(hit, pos, INT64_MAX),
                              "amin")


def genome_kmer_counts(spec: HashSpec, retained: torch.Tensor, path,
                       with_positions: bool = False, rows: int = 0):
    """Multiplicity of each retained k-mer (sorted int64 keys on the device
    that runs the hashing) in one genome FASTA, over every k-mer position.
    With ``with_positions``, also returns each k-mer's first position in the
    concatenated-genome coordinate (-1 if absent) plus the record
    (chromosome) start offsets and names.  ``rows`` sets the row-group
    height (0: ``_ROWS`` of the device); results do not depend on it.
    Returns host numpy arrays."""
    nk = retained.shape[0]
    if nk == 0:
        z = np.zeros(0, np.uint32)
        return ((z, np.zeros(0, np.int64), np.zeros(0, np.int64), [])
                if with_positions else z)
    dev = retained.device
    rows = rows or _ROWS.get(dev.type, 32)
    counts = torch.zeros(nk, dtype=torch.int64, device=dev)
    first_pos = torch.full((nk,), INT64_MAX, dtype=torch.int64, device=dev)
    k = spec.k
    step = _CHUNK - (k - 1)

    chunks = []  # (record codes, start, global genome offset of chunk)
    rec_starts, rec_names = [], []
    genome_off = 0
    for name, seq in fasta_records(path):
        rec_starts.append(genome_off)
        if isinstance(name, bytes):
            name = name.decode("utf-8", "replace")
        rec_names.append(name.split()[0] if name else f"rec{len(rec_names)}")
        codes = ascii_to_codes(seq)
        n = len(codes)
        if n >= k:
            for s in range(0, max(n - k + 1, 1), step):
                chunks.append((codes, s, genome_off + s))
        genome_off += n

    for g in range(0, len(chunks), rows):
        group = chunks[g:g + rows]
        batch = np.full((len(group), _CHUNK), 4, np.uint8)
        lens = np.zeros(len(group), np.int32)
        offs = np.zeros(len(group), np.int64)
        for bi, (codes, s, goff) in enumerate(group):
            piece = codes[s:s + _CHUNK]
            batch[bi, :len(piece)] = piece
            lens[bi] = len(piece)
            offs[bi] = goff
        _scan_group(spec, counts, first_pos, torch.from_numpy(batch).to(dev),
                    torch.from_numpy(lens).to(dev),
                    torch.from_numpy(offs).to(dev), retained)
    counts = counts.cpu().numpy().astype(np.uint32)
    if with_positions:
        fp = first_pos.cpu().numpy()
        fp[fp == INT64_MAX] = -1
        return counts, fp, np.asarray(rec_starts, np.int64), rec_names
    return counts


def build_crib(spec: HashSpec, retained: torch.Tensor, paths: Sequence,
               rows: int = 0) -> Crib:
    """Label retained k-mers against 1 or 2 haplotype FASTAs."""
    if not 1 <= len(paths) <= 2:
        raise ValueError("crib takes one or two haplotype FASTAs")
    c0, positions, rec_starts, rec_names = genome_kmer_counts(
        spec, retained, paths[0], with_positions=True, rows=rows)
    hap_counts = np.stack([c0] + [genome_kmer_counts(spec, retained, p,
                                                     rows=rows)
                                  for p in paths[1:]])
    n = retained.shape[0]
    labels = np.full(n, ERR, np.uint8)
    if len(paths) == 2:
        c1, c2 = hap_counts
        labels[(c1 == 1) & (c2 == 1)] = HOM
        labels[(c1 == 1) & (c2 == 0)] = HET1
        labels[(c1 == 0) & (c2 == 1)] = HET2
        labels[(c1 > 1) | (c2 > 1)] = MUL
    else:
        c1 = hap_counts[0]
        labels[c1 == 1] = HOM
        labels[c1 > 1] = MUL
    return Crib(labels=labels, hap_counts=hap_counts, n_haps=len(paths),
                positions=positions, rec_starts=rec_starts,
                rec_names=rec_names)


def _segment_percentile(sorted_vals: np.ndarray, seg_off: np.ndarray,
                        seg_len: np.ndarray, q: float) -> np.ndarray:
    """np.percentile(.., q, method='linear') per contiguous segment."""
    pos = (seg_len - 1) * (q / 100.0)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    lo = sorted_vals[seg_off + i0]
    hi = sorted_vals[np.minimum(seg_off + i0 + 1, seg_off + seg_len - 1)]
    return lo + frac * (hi - lo)


def crib_report(inc, clusters: torch.Tensor, crib: Crib,
                out=sys.stdout) -> int:
    """Per-cluster label composition + haplotype purity (the crib half of
    ``--clusterReport``), from the port's incidence and flat labels.
    Purity = dominant-haplotype fraction among HET k-mers; clusters with no
    HET k-mers report purity -.  Host numpy over the flat (code, cluster)
    key space; spans are inner-80% hap1 positions within each cluster's
    dominant chromosome.  Returns the number of clusters reported."""
    code_offsets = inc.code_offsets.cpu().numpy()
    code_kmers = inc.code_kmers.cpu().numpy()
    comp = crib.composition()
    out.write("crib totals " + " ".join(
        f"{LABEL_NAMES[l]} {int(comp[l])}" for l in range(5)) + "\n")
    n_pairs = len(code_kmers)
    flat_cl = clusters.cpu().numpy().astype(np.int64) if n_pairs \
        else np.zeros(0, np.int64)
    code_of_p = np.repeat(np.arange(inc.n_codes, dtype=np.int64),
                          np.diff(code_offsets))
    K = int(flat_cl.max()) + 1 if n_pairs else 1
    combined = code_of_p * K + flat_cl
    # global cluster ids in (code, cluster) order — the report's line order
    uniq, gid, csize = np.unique(combined, return_inverse=True,
                                 return_counts=True)
    G = len(uniq)
    lab_of_p = crib.labels[code_kmers].astype(np.int64)
    lc = np.bincount(gid * 5 + lab_of_p, minlength=G * 5).reshape(G, 5)
    h1, h2 = lc[:, HET1], lc[:, HET2]
    het = h1 + h2
    dom = np.maximum(h1, h2)
    spans = np.full(G, -1, np.int64)
    chrom_g = np.full(G, -1, np.int64)
    if crib.positions is not None and n_pairs:
        pp = crib.positions[code_kmers]
        ok = pp >= 0
        gv, pv = gid[ok], pp[ok]
        cv = crib.chrom_of(pv)
        n_rec = len(crib.rec_starts) if crib.rec_starts is not None else 0
        if n_rec and len(gv):
            # dominant chrom per cluster: most k-mers, smallest id on ties
            key = gv * n_rec + cv
            ukey, kcnt = np.unique(key, return_counts=True)
            u_g, u_c = ukey // n_rec, ukey % n_rec
            order = np.lexsort((u_c, -kcnt, u_g))
            first = np.concatenate([[True], u_g[order][1:] != u_g[order][:-1]])
            chrom_g[u_g[order][first]] = u_c[order][first]
            # spans over record-LOCAL positions of the dominant chrom only
            keep = cv == chrom_g[gv]
            gv2 = gv[keep]
            pv2 = pv[keep] - crib.rec_starts[cv[keep]]
            order2 = np.lexsort((pv2, gv2))
            gv2, pv2 = gv2[order2], pv2[order2]
            seg_len = np.bincount(gv2, minlength=G)
            seg_off = np.concatenate([[0], np.cumsum(seg_len)])[:-1]
            enough = seg_len >= 5
            if enough.any():
                p90 = _segment_percentile(pv2, seg_off[enough],
                                          seg_len[enough], 90)
                p10 = _segment_percentile(pv2, seg_off[enough],
                                          seg_len[enough], 10)
                spans[enough] = (p90 - p10).astype(np.int64)
    names = crib.rec_names or []
    # one line per cluster, formatted from Python lists: indexing numpy
    # scalars per line took ~5 s of a 6 s report at 459k clusters
    lines = []
    for code, lab, n, hom, a, b, mul, err, d, ht, sp, ch in zip(
            *(x.tolist() for x in (uniq // K, uniq % K, csize, lc[:, HOM],
                                   h1, h2, lc[:, MUL], lc[:, ERR], dom, het,
                                   spans, chrom_g))):
        pstr = f"{d / ht:.3f}" if ht else "-"
        sstr = str(sp) if sp >= 0 else "-"
        cstr = names[ch] if 0 <= ch < len(names) else "-"
        lines.append(
            f"code {code} cluster {lab} n {n} hom {hom} het1 {a} het2 {b} "
            f"mul {mul} err {err} purity {pstr} chrom {cstr} span {sstr}\n")
    out.write("".join(lines))
    total_het = int(het.sum())
    if total_het:
        out.write(f"crib overall purity {int(dom.sum()) / total_het:.4f} "
                  f"over {total_het} het kmers\n")
    return G
