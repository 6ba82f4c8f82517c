"""Crib (ground-truth) evaluation: label table k-mers from haplotype
assemblies — the port of ``hash10x_tpu/crib/crib.py``.

Models the reference's crib mechanism (``hash10x.c:~cribBuild`` + crib
report, SURVEY.md §3.1 #10): hash every genome k-mer of one or two haplotype
FASTAs of the same sample, look each up in the retained table, and label
table k-mers HOM (single-copy in both haplotypes) / HET1 / HET2 (single-copy
in exactly one) / MUL (multi-copy) / ERR (absent from both), so cluster
purity and haplotype phasing can be scored.

Genome hashing runs through the sketch kernel's dense kmer mode
(``kernels.minimizer.sketch``): each FASTA record is read as base codes
(``bytes.translate`` as the file streams), copied to the device once, and
cut there into rows of ``_CHUNK`` bases with a k - 1 overlap, so every
genome k-mer is hashed in exactly one row.  On a CUDA device a row group
is as tall as a record allows (``_ROWS``: a 100 Mb record is one launch
of the kernel and of the lookup around it); results do not depend on the
height.
The lookup is a ``searchsorted`` against the sorted retained keys, and the
multiplicity and first position of each retained k-mer accumulate on the
device.  ``Crib`` holds host numpy arrays, as in the JAX package;
``crib_report`` computes on the incidence's device (one line per molecule,
millions on a real lane) and renders its lines through ``utils/text.py``.
"""

from __future__ import annotations

import sys
import warnings
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from .. import INT64_MAX
from ..core.encode import CODE_TABLE
from ..hashspec import HashSpec
from ..io.fastq import fasta_records
from ..kernels import minimizer
from ..utils.text import write_rows

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
    rec_starts, rec_names = [], []
    genome_off = 0
    for name, seq in fasta_records(path, table=CODE_TABLE):
        rec_starts.append(genome_off)
        if isinstance(name, bytes):
            name = name.decode("utf-8", "replace")
        rec_names.append(name.split()[0] if name else f"rec{len(rec_names)}")
        n = len(seq)
        if n >= k:
            # rows start every ``step`` bases; the record goes to the
            # device once and its rows are views of it, padded with code 4
            n_rows = -(-(n - k + 1) // step)
            codes = torch.full(((n_rows - 1) * step + _CHUNK,), 4,
                               dtype=torch.uint8, device=dev)
            with warnings.catch_warnings():   # read only: copied at once
                warnings.simplefilter("ignore")
                codes[:n] = torch.frombuffer(seq, dtype=torch.uint8)
            starts = torch.arange(n_rows, device=dev) * step
            lens = torch.clamp(n - starts, max=_CHUNK).to(torch.int32)
            view = codes.unfold(0, _CHUNK, step)
            for g in range(0, n_rows, rows):
                _scan_group(spec, counts, first_pos,
                            view[g:g + rows].contiguous(), lens[g:g + rows],
                            genome_off + starts[g:g + rows], retained)
        genome_off += n
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


def _segment_percentile(sorted_vals: torch.Tensor, seg_off: torch.Tensor,
                        seg_len: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(.., q, method='linear') per contiguous segment, in
    float64 with numpy's operations in numpy's order."""
    pos = (seg_len - 1).to(torch.float64) * (q / 100.0)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0.to(torch.float64)
    lo = sorted_vals[seg_off + i0]
    hi = sorted_vals[torch.minimum(seg_off + i0 + 1, seg_off + seg_len - 1)]
    return lo.to(torch.float64) + frac * (hi - lo).to(torch.float64)


def _purity_thousandths(dom: torch.Tensor, het: torch.Tensor) -> torch.Tensor:
    """``f"{dom / het:.3f}"`` as an integer count of thousandths, -1 where
    het is 0.  Integer rounding of 1000 * dom / het agrees with rounding
    the double dom / het except at exact ties (2000 * dom an odd multiple
    of het), where the double lies on either side of the tie or on it: those
    rows take Python's formatting of the double."""
    h = torch.clamp(het, min=1)
    r = (2000 * dom + h) // (2 * h)
    tie = ((2000 * dom) % (2 * h) == h) & (het > 0)
    idx = torch.nonzero(tie).squeeze(1)
    if idx.numel():
        fixed = [int(f"{d / t:.3f}".replace(".", "")) for d, t in
                 zip(dom[idx].tolist(), het[idx].tolist())]
        r[idx] = torch.tensor(fixed, dtype=torch.int64, device=r.device)
    return torch.where(het > 0, r, -1)


def crib_report(inc, clusters: torch.Tensor, crib: Crib,
                out=sys.stdout) -> int:
    """Per-cluster label composition + haplotype purity (the crib half of
    ``--clusterReport``), from the port's incidence and flat labels.
    Purity = dominant-haplotype fraction among HET k-mers; clusters with no
    HET k-mers report purity -.  Computed on the incidence's device over the
    flat (code, cluster) key space; spans are inner-80% hap1 positions
    within each cluster's dominant chromosome.  Returns the number of
    clusters reported."""
    dev = inc.device
    comp = crib.composition()
    out.write("crib totals " + " ".join(
        f"{LABEL_NAMES[l]} {int(comp[l])}" for l in range(5)) + "\n")
    if inc.n_pairs == 0:
        return 0
    km = inc.code_kmers
    flat_cl = clusters.to(torch.int64)
    K = int(flat_cl.max()) + 1
    # global cluster ids in (code, cluster) order: the report's line order
    uniq, gid, csize = torch.unique(inc.code_of_pair() * K + flat_cl,
                                    sorted=True, return_inverse=True,
                                    return_counts=True)
    G = uniq.shape[0]
    lab_of_p = torch.from_numpy(crib.labels).to(dev)[km].to(torch.int64)
    lc = torch.bincount(gid * 5 + lab_of_p, minlength=G * 5).reshape(G, 5)
    h1, h2 = lc[:, HET1], lc[:, HET2]
    het = h1 + h2
    dom = torch.maximum(h1, h2)
    spans = torch.full((G,), -1, dtype=torch.int64, device=dev)
    chrom_g = torch.full((G,), -1, dtype=torch.int64, device=dev)
    n_rec = len(crib.rec_starts) if crib.rec_starts is not None else 0
    if crib.positions is not None and n_rec:
        pp = torch.from_numpy(crib.positions).to(dev)[km]
        ok = pp >= 0
        gv, pv = gid[ok], pp[ok]
        starts = torch.from_numpy(crib.rec_starts).to(dev)
        cv = torch.searchsorted(starts, pv, right=True) - 1
        if gv.numel():
            # dominant chrom per cluster: most k-mers, smallest id on ties
            ukey, kcnt = torch.unique(gv * n_rec + cv, return_counts=True)
            u_g, u_c = ukey // n_rec, ukey % n_rec
            best = torch.full((G,), -1, dtype=torch.int64, device=dev)
            best.scatter_reduce_(0, u_g, kcnt * n_rec + (n_rec - 1 - u_c),
                                 "amax")
            chrom_g = torch.where(best >= 0, n_rec - 1 - best % n_rec, -1)
            # spans over record-LOCAL positions of the dominant chrom only
            keep = cv == chrom_g[gv]
            gv2 = gv[keep]
            pv2 = pv[keep] - starts[cv[keep]]
            o = torch.argsort(pv2, stable=True)
            o = o[torch.argsort(gv2[o], stable=True)]
            pv2 = pv2[o]
            seg_len = torch.bincount(gv2, minlength=G)
            seg_off = torch.cumsum(seg_len, 0) - seg_len
            enough = seg_len >= 5
            sl, so = seg_len[enough], seg_off[enough]
            spans[enough] = (_segment_percentile(pv2, so, sl, 90)
                             - _segment_percentile(pv2, so, sl, 10)
                             ).to(torch.int64)
    write_rows(out, [
        b"code ", ("d", uniq // K), b" cluster ", ("d", uniq % K), b" n ",
        ("d", csize), b" hom ", ("d", lc[:, HOM]), b" het1 ", ("d", h1),
        b" het2 ", ("d", h2), b" mul ", ("d", lc[:, MUL]), b" err ",
        ("d", lc[:, ERR]), b" purity ", ("f3", _purity_thousandths(dom, het)),
        b" chrom ", ("s", chrom_g, crib.rec_names or []), b" span ",
        ("d-", spans), b"\n"], G, dev)
    total_het = int(het.sum())
    if total_het:
        out.write(f"crib overall purity {int(dom.sum()) / total_het:.4f} "
                  f"over {total_het} het kmers\n")
    return G
