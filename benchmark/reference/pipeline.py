"""A lane's count band, incidence, friend clusters, split and report, worked
out again from the packed reads in plain torch (see ``seqhash``).

1. **Band.**  Every read's minimizers; the distinct (barcode, hash) pairs;
   a hash's count is the number of distinct barcodes that hold it; the
   band keeps the hashes whose count lies in [lo, hi], ascending.  A k-mer's
   id is its rank in the band.
2. **Incidence.**  The distinct (barcode, k-mer id) pairs of the band,
   sorted by barcode and then k-mer (the forward CSR), and by k-mer and
   then barcode (the inverted CSR).
3. **Friend clusters.**  A barcode c' is a friend of c when they share at
   least ``min_friend_share`` k-mers.  Two of c's k-mers are in one
   molecule when a friend holds both; molecules are the connected
   components.  Worked per block of barcodes, since components never cross
   barcodes: each (c, k-mer) node is joined to every other barcode of its
   k-mer, the shares counted over those, and labels propagated between the
   nodes and the (c, friend) groups to a fixed point.  Each component is
   labelled by its first k-mer, and the labels of a barcode are numbered
   0, 1, ... in the order of their first k-mers.
4. **Split and report.**  One molecule per distinct (barcode, label),
   ascending; one report line per barcode:
   ``code c nKmers n nClusters m sizes s0,s1,...``.

``distinct_barcodes=False`` counts every emission instead of every distinct
barcode: the control, which breaks the configuration's guarantee that a
count is a number of barcodes.

The entries that the traffic mixes name (``reference/<name>.py``) put these
steps together.
"""

from __future__ import annotations

import numpy as np
import torch

from .seqhash import hash_factor, minimizers

__all__ = ["require", "on_device", "barcode_counts", "band_and_incidence",
           "friend_clusters", "molecules", "report_text"]

READ_BLOCK = 1 << 19     # reads sketched at once
TRIPLES = 1 << 28        # (node, other barcode) entries per cluster block


def require(cfg: dict, **want) -> None:
    """Refuse a configuration whose settings this reference does not hold."""
    got = {k: cfg[k] for k in want}
    if got != want:
        raise ValueError(f"the reference holds {want} only, not {got}")


def on_device(lane, device) -> tuple:
    """(packed reads (n, words) int32, barcode ids (n,)) of ``lane`` (a
    ``benchmark.lane.Lane``) on ``device``."""
    return (torch.from_numpy(lane.packed.view(np.int32)).to(device),
            torch.from_numpy(lane.barcode_ids).to(device))


def _csr_offsets(ids: torch.Tensor, n: int) -> torch.Tensor:
    off = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    off[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
    return off


def barcode_counts(packed: torch.Tensor, barcode_ids: torch.Tensor,
                   read_len: int, n_codes: int, k: int, w: int, seed: int,
                   distinct_barcodes: bool = True):
    """Step 1's counts on the reads (``packed`` (n, words) int32 and
    ``barcode_ids`` (n,) on one device).  Returns (distinct (barcode, hash)
    keys ascending, the distinct hashes ascending, their counts, emitted
    positions)."""
    factor = hash_factor(seed)
    hb = 2 * k
    if (n_codes - 1).bit_length() + hb > 63:
        raise ValueError("(barcode, hash) does not fit one int64 key")
    pairs, emissions, emitted = [], [], 0
    for a in range(0, packed.shape[0], READ_BLOCK):
        h, e = minimizers(packed[a:a + READ_BLOCK], read_len, k, w, factor)
        bc = barcode_ids[a:a + READ_BLOCK].to(torch.int64)
        keys = ((bc[:, None] << hb) | h)[e]
        emitted += keys.shape[0]
        if not distinct_barcodes:
            emissions.append(keys & ((1 << hb) - 1))
        pairs.append(torch.unique(keys))
        del h, e, keys
    pairs = torch.unique(torch.cat(pairs))
    counted = (pairs & ((1 << hb) - 1) if distinct_barcodes
               else torch.cat(emissions))
    del emissions
    uh, counts = torch.unique(counted, return_counts=True)
    return pairs, uh, counts, emitted


def band_and_incidence(packed: torch.Tensor, barcode_ids: torch.Tensor,
                       read_len: int, n_codes: int, k: int, w: int,
                       seed: int, lo: int, hi: int,
                       distinct_barcodes: bool = True):
    """Steps 1-2.  Returns (band hashes, counts, code_offsets, code_kmers,
    emitted positions)."""
    pairs, uh, counts, emitted = barcode_counts(
        packed, barcode_ids, read_len, n_codes, k, w, seed,
        distinct_barcodes)
    hb = 2 * k
    hashes = pairs & ((1 << hb) - 1)
    keep = (counts >= lo) & (counts <= hi)
    retained, counts = uh[keep], counts[keep]
    del uh, keep
    ids = torch.searchsorted(retained, hashes).clamp_(
        max=max(retained.shape[0] - 1, 0))
    inband = (retained[ids] == hashes if retained.numel()
              else torch.zeros_like(hashes, dtype=torch.bool))
    codes = pairs[inband] >> hb
    code_kmers = ids[inband]
    return (retained, counts, _csr_offsets(codes, n_codes), code_kmers,
            emitted)


def _inverted(code_offsets, code_kmers, n_kmers: int):
    """The inverted CSR: (kmer_offsets, kmer_codes sorted by (k-mer,
    barcode))."""
    n_codes = code_offsets.shape[0] - 1
    codes = torch.repeat_interleave(
        torch.arange(n_codes, device=code_kmers.device),
        torch.diff(code_offsets))
    key = torch.sort(code_kmers * n_codes + codes).values
    return _csr_offsets(key // n_codes, n_kmers), key % n_codes


def _propagate(n: int, node: torch.Tensor, group: torch.Tensor,
               n_groups: int) -> torch.Tensor:
    """Each node's smallest connected node index, nodes joined through
    the groups that hold them."""
    dev = node.device
    lab = torch.arange(n, device=dev)
    while True:
        gmin = torch.full((n_groups,), n, dtype=torch.int64, device=dev)
        gmin.scatter_reduce_(0, group, lab[node], "amin")
        new = lab.scatter_reduce(0, node, gmin[group], "amin")
        while True:   # a label is a smaller node of the same component
            nxt = new[new]
            if torch.equal(nxt, new):
                break
            new = nxt
        if torch.equal(new, lab):
            return lab
        lab = new


def friend_clusters(code_offsets: torch.Tensor, code_kmers: torch.Tensor,
                    n_kmers: int, min_friend_share: int,
                    triples: int = TRIPLES) -> torch.Tensor:
    """Step 3: the canonical label of every forward-CSR pair."""
    dev = code_kmers.device
    n_codes = code_offsets.shape[0] - 1
    kmer_offsets, kmer_codes = _inverted(code_offsets, code_kmers, n_kmers)
    deg = torch.diff(kmer_offsets)
    # entries each barcode's nodes join: its k-mers' other barcodes
    per_pair = deg[code_kmers] - 1
    cum = torch.zeros(code_kmers.shape[0] + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(per_pair, 0)
    at_code = cum[code_offsets]
    marks = torch.arange(1, int(at_code[-1]) // triples + 1,
                         device=dev) * triples
    cuts = torch.searchsorted(at_code, marks)
    bounds = sorted({0, n_codes, *cuts.clamp(max=n_codes).tolist()})
    labels = torch.empty_like(code_kmers)
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        p0, p1 = int(code_offsets[c0]), int(code_offsets[c1])
        if p1 == p0:
            continue
        n = p1 - p0
        code = torch.repeat_interleave(
            torch.arange(c0, c1, device=dev),
            torch.diff(code_offsets[c0:c1 + 1]))
        kmer = code_kmers[p0:p1]
        d = deg[kmer]
        node = torch.repeat_interleave(torch.arange(n, device=dev), d)
        start = torch.cumsum(d, 0) - d
        q = (torch.arange(node.shape[0], device=dev) - start[node]
             + kmer_offsets[kmer][node])
        other = kmer_codes[q]
        keep = other != code[node]
        node, other = node[keep], other[keep]
        del q, keep, start
        grp_key = (code[node] - c0) * n_codes + other
        keys, group, share = torch.unique(grp_key, return_inverse=True,
                                          return_counts=True)
        del grp_key
        friend = (share >= min_friend_share)[group]
        lab = _propagate(n, node[friend], group[friend], keys.shape[0])
        del node, other, group, friend
        # labels: components numbered per barcode by their first k-mer
        root = torch.cumsum(lab == torch.arange(n, device=dev), 0)
        first = code_offsets[code] - p0
        labels[p0:p1] = root[lab] - root[first]
    return labels


def molecules(code_offsets: torch.Tensor, labels: torch.Tensor):
    """Step 4: ((M, 2) (barcode, label) per molecule, ascending; (M,) sizes;
    (C,) molecules per barcode)."""
    n_codes = code_offsets.shape[0] - 1
    code = torch.repeat_interleave(
        torch.arange(n_codes, device=labels.device),
        torch.diff(code_offsets))
    K = int(labels.max()) + 1 if labels.numel() else 1
    uniq, sizes = torch.unique(code * K + labels, return_counts=True)
    origin = torch.stack([uniq // K, uniq % K], 1)
    per_code = torch.bincount(origin[:, 0], minlength=n_codes)
    return origin, sizes, per_code


def report_text(n_kmers: np.ndarray, per_code: np.ndarray,
                sizes: np.ndarray) -> str:
    """The report lines of step 4."""
    words = sizes.astype(str).tolist()
    ends = np.cumsum(per_code).tolist()
    lines, a = [], 0
    for c, (nk, nc, b) in enumerate(zip(n_kmers.tolist(), per_code.tolist(),
                                        ends)):
        lines.append(f"code {c} nKmers {nk} nClusters {nc} sizes "
                     f"{','.join(words[a:b])}\n")
        a = b
    return "".join(lines)
