"""The reference of a whole pass under the capped-friend contract (the mix
``capped``): the band, the incidence, capped-friend clustering, the split
and the report, in the numbers that mix compares.

The capped-friend contract is the JAX package's oracle
``cluster_barcode_friend`` (``--maxFriends n``): for a barcode c, its
friends are the other barcodes that hold at least ``min_friend_share`` of
c's k-mers, ranked by that share, highest first, ties to the smaller id,
and only the first ``max_friends`` are kept; a k-mer of c links to a kept
friend when that friend holds it, and c's molecules are the connected
components of those links, numbered 0, 1, ... in the order of their first
k-mers (k-mer ids ascending).  ``capped_clusters`` works it out per block
of barcodes, since components never cross barcodes:

1. every (position, other holder) entry: each k-mer of c joined to every
   other barcode that holds it;
2. the share of each (c, other barcode): its entries counted;
3. friends: the others of share >= ``min_friend_share``;
4. each barcode's friends ranked by (-share, id), those of rank <
   ``max_friends`` kept;
5. each position linked to every kept friend that holds its k-mer (its
   entries with those friends);
6. labels by min-label propagation between the positions and the kept
   (c, friend) groups, with pointer jumping, to the fixed point: each
   position's label is the smallest position of its component;
7. components numbered per barcode by their first k-mer.

Departures from the oracle: it ranks a barcode's shares in a Python sort,
unions each k-mer with the first earlier k-mer held by the same friend by
union-find, and walks barcodes one at a time; here the ranks come from two
stable sorts of each block's (barcode, other) groups and the components
from propagation over the whole block, which give the same ranks and the
same partition.  All arithmetic is on integers, so every check is exact.
"""

from __future__ import annotations

import torch

from . import pipeline

__all__ = ["capped_clusters", "reference"]


def _kept(keys: torch.Tensor, share: torch.Tensor, n_codes: int,
          n_block: int, min_friend_share: int,
          max_friends: int) -> torch.Tensor:
    """Steps 3-4 over the (barcode, other) groups of a block of ``n_block``
    barcodes (``keys``: block-local barcode * n_codes + other, ascending;
    ``share``): whether each group is a kept friend."""
    dev = keys.device
    code = keys // n_codes
    friend = share >= min_friend_share
    g = torch.nonzero(friend).squeeze(1)      # (barcode, other) ascending
    g = g[torch.argsort(-share[g], stable=True)]
    g = g[torch.argsort(code[g], stable=True)]  # barcode; -share; other
    per = torch.bincount(code[g], minlength=n_block)
    rank = (torch.arange(g.shape[0], device=dev)
            - (torch.cumsum(per, 0) - per)[code[g]])
    kept = torch.zeros_like(friend)
    kept[g[rank < max_friends]] = True
    return kept


def capped_clusters(code_offsets: torch.Tensor, code_kmers: torch.Tensor,
                    n_kmers: int, min_friend_share: int, max_friends: int,
                    triples: int = pipeline.TRIPLES) -> torch.Tensor:
    """The canonical label of every forward-CSR pair (``code_offsets``,
    ``code_kmers``: barcode-major, k-mer ids ascending in a barcode) under
    the capped-friend contract, in blocks of about ``triples`` entries."""
    if max_friends <= 0:
        raise ValueError("the capped contract needs max_friends > 0")
    dev = code_kmers.device
    n_codes = code_offsets.shape[0] - 1
    kmer_offsets, kmer_codes = pipeline._inverted(code_offsets, code_kmers,
                                                  n_kmers)
    deg = torch.diff(kmer_offsets)
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
        # 1. every (position, other holder) entry
        d = deg[kmer]
        node = torch.repeat_interleave(torch.arange(n, device=dev), d)
        start = torch.cumsum(d, 0) - d
        other = kmer_codes[torch.arange(node.shape[0], device=dev)
                           - start[node] + kmer_offsets[kmer][node]]
        keep = other != code[node]
        node, other = node[keep], other[keep]
        del keep, start
        # 2. shares per (barcode, other)
        key = (code[node] - c0) * n_codes + other
        del other
        keys, group, share = torch.unique(key, return_inverse=True,
                                          return_counts=True)
        del key
        # 3-5. the entries of kept friends
        linked = _kept(keys, share, n_codes, c1 - c0, min_friend_share,
                       max_friends)[group]
        # 6. components of positions and kept friends
        lab = pipeline._propagate(n, node[linked], group[linked],
                                  keys.shape[0])
        del node, group, linked
        # 7. numbered per barcode by their first k-mer
        root = torch.cumsum(lab == torch.arange(n, device=dev), 0)
        first = code_offsets[code] - p0
        labels[p0:p1] = root[lab] - root[first]
    return labels


def reference(lane, cfg: dict, device, control: bool = False):
    """({check: [part]}, {"emitted": minimizer positions}) of ``lane``;
    ``control`` counts every emission in place of every distinct
    barcode."""
    pipeline.require(cfg, mode="minimizer", count_mode="barcodes",
                     cluster_mode="friend")
    packed, bcs = pipeline.on_device(lane, device)
    lo, hi = cfg["band"]
    retained, counts, offsets, kmers, emitted = pipeline.band_and_incidence(
        packed, bcs, lane.read_len, lane.n_codes, cfg["k"], cfg["w"],
        cfg["hash_seed"], lo, hi, distinct_barcodes=not control)
    del packed, bcs
    labels = capped_clusters(offsets, kmers, retained.shape[0],
                             cfg["min_friend_share"], cfg["max_friends"])
    origin, sizes, per_code = pipeline.molecules(offsets, labels)
    text = pipeline.report_text(torch.diff(offsets).cpu().numpy(),
                                per_code.cpu().numpy(), sizes.cpu().numpy())
    return ({"band": [retained, counts], "pairs": [offsets, kmers],
             "labels": [labels], "molecules": [origin],
             "report_lines": [text]},
            {"emitted": emitted})
