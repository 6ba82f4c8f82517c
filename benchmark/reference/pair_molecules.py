"""The reference of a whole pass under the pair contract (the mix ``pair``):
the band, the incidence, pair-support clustering, the split and the report,
in the numbers that mix compares.

The pair contract is the source's ``codeClusterFind`` as the JAX package's
oracle (``cluster_barcode``) states it: for a barcode c, two of its k-mers
link when the barcodes that hold both, c itself left out, number at least
``min_share``; c's molecules are the connected components of those links,
numbered 0, 1, ... in the order of their first k-mers (k-mer ids
ascending).  ``pair_clusters`` works it out per block of barcodes, since
components never cross barcodes:

1. each barcode's 0/1 matrix M: a row per k-mer, a column per barcode that
   holds any of its k-mers (c itself among them), padded to the block's
   largest;
2. the support S = M M^T, counted in float64;
3. a link where S - 1 >= ``min_share`` between two of the barcode's
   k-mers;
4. labels by min-label propagation with pointer jumping, to the fixed
   point: each k-mer's label is the smallest index of its component;
5. components numbered by their first k-mer.

Departures from the oracle: it joins each linked pair by union-find as it
meets it, and counts a pair's support by walking the two sorted barcode
lists; here the components come from propagation, which gives the same
partition, and the support from a product of 0/1 matrices, whose float64
sums are exact far past any list's length.
"""

from __future__ import annotations

import torch

from . import pipeline

__all__ = ["pair_clusters", "reference"]

BLOCK_CELLS = 1 << 28    # padded (k-mer, k-mer) cells of a block of barcodes


def _block(code_offsets, code_kmers, kmer_offsets, kmer_codes, c0: int,
           c1: int, min_share: int) -> torch.Tensor:
    """The canonical labels of the pairs of barcodes [c0, c1)."""
    dev = code_kmers.device
    n_codes = code_offsets.shape[0] - 1
    p0 = int(code_offsets[c0])
    B = c1 - c0
    size = torch.diff(code_offsets[c0:c1 + 1])
    N = int(size.max())
    n = int(size.sum())
    kmer = code_kmers[p0:p0 + n]
    code = torch.repeat_interleave(torch.arange(B, device=dev), size)
    row = torch.arange(n, device=dev) - (code_offsets[c0:c1] - p0)[code]
    # every (pair, holder) entry: the barcodes that hold each pair's k-mer
    deg = torch.diff(kmer_offsets)[kmer]
    entry = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    start = torch.cumsum(deg, 0) - deg
    holder = kmer_codes[torch.arange(entry.shape[0], device=dev)
                        - start[entry] + kmer_offsets[kmer][entry]]
    # a barcode's columns: its holders, in ascending id
    key = code[entry] * n_codes + holder
    uniq, col = torch.unique(key, return_inverse=True)
    col = col - torch.searchsorted(
        uniq, torch.arange(B, device=dev) * n_codes)[code[entry]]
    U = int(col.max()) + 1
    m = torch.zeros((B, N, U), dtype=torch.float64, device=dev)
    m[code[entry], row[entry], col] = 1.0
    del deg, entry, start, holder, key, uniq, col
    s = torch.bmm(m, m.transpose(1, 2))
    del m
    iota = torch.arange(N, device=dev)
    real = iota[None, :] < size[:, None]
    link = (s - 1.0 >= min_share) & real[:, :, None] & real[:, None, :]
    del s
    lab = iota.expand(B, N).contiguous()
    while True:
        new = torch.minimum(
            lab, torch.where(link, lab[:, None, :], N).amin(dim=2))
        while True:   # a label is a smaller k-mer of the same component
            nxt = torch.gather(new, 1, new)
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, lab):
            break
        lab = new
    # labels: components numbered by their first k-mer
    root = torch.cumsum((lab == iota).to(torch.int64), dim=1)
    canon = torch.gather(root, 1, lab) - 1
    return canon[code, row]


def pair_clusters(code_offsets: torch.Tensor, code_kmers: torch.Tensor,
                  n_kmers: int, min_share: int,
                  cells: int = BLOCK_CELLS) -> torch.Tensor:
    """The canonical label of every forward-CSR pair (``code_offsets``,
    ``code_kmers``: barcode-major, k-mer ids ascending in a barcode) under
    the pair contract with threshold ``min_share``."""
    n_codes = code_offsets.shape[0] - 1
    labels = torch.empty_like(code_kmers)
    if code_kmers.numel() == 0:
        return labels
    kmer_offsets, kmer_codes = pipeline._inverted(code_offsets, code_kmers,
                                                  n_kmers)
    N = int(torch.diff(code_offsets).max())
    per = max(1, cells // (N * N))
    for c0 in range(0, n_codes, per):
        c1 = min(c0 + per, n_codes)
        p0, p1 = int(code_offsets[c0]), int(code_offsets[c1])
        if p1 > p0:
            labels[p0:p1] = _block(code_offsets, code_kmers, kmer_offsets,
                                   kmer_codes, c0, c1, min_share)
    return labels


def reference(lane, cfg: dict, device, control: bool = False):
    """({check: [part]}, {"emitted": minimizer positions}) of ``lane``;
    ``control`` counts every emission in place of every distinct
    barcode."""
    pipeline.require(cfg, mode="minimizer", count_mode="barcodes",
                     cluster_mode="pair")
    packed, bcs = pipeline.on_device(lane, device)
    lo, hi = cfg["band"]
    retained, counts, offsets, kmers, emitted = pipeline.band_and_incidence(
        packed, bcs, lane.read_len, lane.n_codes, cfg["k"], cfg["w"],
        cfg["hash_seed"], lo, hi, distinct_barcodes=not control)
    del packed, bcs
    labels = pair_clusters(offsets, kmers, retained.shape[0],
                           cfg["min_share"])
    origin, sizes, per_code = pipeline.molecules(offsets, labels)
    text = pipeline.report_text(torch.diff(offsets).cpu().numpy(),
                                per_code.cpu().numpy(), sizes.cpu().numpy())
    return ({"band": [retained, counts], "pairs": [offsets, kmers],
             "labels": [labels], "molecules": [origin],
             "report_lines": [text]},
            {"emitted": emitted})
