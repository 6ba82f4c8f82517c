"""Sparse global friend clustering on a torch device — the port of
``hash10x_tpu/cluster/sparse.py`` (the ``--codeClusters`` path with
uncapped friends).

For each barcode c, two of its k-mers belong to one molecule when some
friend barcode (one sharing at least ``min_friend_share`` k-mers with c)
holds both; molecules are the connected components.  Device memory is
proportional to the pair set, never n_codes^2:

1. **Shift join.**  The inverted CSR (codes per k-mer, ascending) is
   reordered so longer lists come first.  For a distance d, every
   (codes[i], codes[i+d]) inside one list is a co-occurring pair with
   c1 < c2, and the lists still holding pairs at distance d form a prefix.
2. **Co-occurrence counts.**  The pair keys c1 * n_codes + c2 of all d are
   sorted and their runs counted: share(c1, c2).
3. **Friend set.**  Pairs with share >= threshold, mirrored to both orders
   and sorted.
4. **Edges.**  A second sweep links each forward-CSR position p = (c1, h)
   to friend node f = rank of (c1, c2) for every friend c2 that also holds h
   (and the mirror edge for (c2, h)).
5. **Min-label propagation** over the bipartite (position, friend) graph
   with pointer jumping; labels are global forward positions, so the fixed
   point is each component's minimum position.  Components never cross
   barcodes.  The barcode's code offset turns it into the local index, and
   a dense rank per barcode gives the canonical first-appearance numbering
   of ``hash10x_tpu/oracle/cluster_ref.cluster_barcode_friend``.

On the GPU plain gathers and ``scatter_reduce(amin)`` are the natural form;
the JAX package's sort-only joins were TPU workarounds.

Spans of the current timer (``utils/timing.py``; the engine's while it
clusters): ``cluster.cooccur`` (steps 1-2) with a ``cluster.cooccur.reduce``
per reduction, ``cluster.friends`` (3), ``cluster.edges`` (4) and a
``cluster.round`` per propagation round (5).  Every device sort adds its
elements to the counter ``sorted_keys``.
"""

from __future__ import annotations

import torch

from ..table.incidence import Incidence
from ..table.sorted_table import segment_sum_sorted
from ..utils import timing
from ..utils.dense import device_dense_ranks, distinct_below

__all__ = ["cooccurrence_counts", "friend_pairs", "friend_keys",
           "propagate_labels", "canonical_ranks", "cluster_codes_sparse",
           "STATS"]

# co-occurrence keys held before a reduction (bounds enumeration memory)
_CHUNK = 1 << 25
# edges per scatter in one propagation round (bounds per-launch temporaries)
_EDGE_BLOCK = 1 << 25
_BIG = (1 << 62)

# host figures of the last clustering, read by callers that report them:
# co-occurrence keys ("cooccur_keys"), friend keys in both orders
# ("friend_keys"), edges ("edges"), their blocks ("edge_blocks") and
# propagation rounds ("rounds")
STATS: dict = {}


class _ShiftJoin:
    """Length-ordered inverted CSR for the shift-join sweeps."""

    def __init__(self, inc: Incidence):
        dev = inc.device
        lens = torch.diff(inc.kmer_offsets)
        timing.add("sorted_keys", lens.shape[0])
        order = torch.argsort(-lens, stable=True)
        sl = lens[order]
        new_off = torch.cat([sl.new_zeros(1), torch.cumsum(sl, 0)])
        starts = inc.kmer_offsets[:-1][order]
        self.pos_old = (torch.arange(inc.n_pairs, device=dev)
                        - torch.repeat_interleave(new_off[:-1], sl)
                        + torch.repeat_interleave(starts, sl))
        self.codes = inc.kmer_codes[self.pos_old]
        self.seg = torch.repeat_interleave(
            torch.arange(sl.shape[0], device=dev), sl)
        # entries in lists of each length L, summed over lengths >= L: only
        # this (max length + 1)-long vector crosses to the host
        per_len = torch.bincount(lens)
        per_len = per_len * torch.arange(per_len.shape[0], device=dev)
        self._at_least = torch.cumsum(per_len.flip(0), 0).flip(0).cpu().numpy()
        self.D = len(self._at_least) - 1  # longest list

    def b(self, d: int) -> int:
        """Entries in lists still holding pairs at distance d (a prefix:
        lists with length >= d + 1)."""
        return int(self._at_least[d + 1]) if d + 1 <= self.D else 0

    def pairs(self, d: int):
        """(c1, c2, i): every same-list pair at distance d, as codes and the
        length-ordered index i of c1 (c2 sits at i + d)."""
        b = self.b(d)
        i = torch.nonzero(self.seg[:b - d] == self.seg[d:b]).squeeze(1)
        return self.codes[i], self.codes[i + d], i


def cooccurrence_counts(inc: Incidence, chunk: int = _CHUNK):
    """Sorted c1 < c2 co-occurrence keys c1 * n_codes + c2 and their shares
    (the number of k-mers both barcodes hold)."""
    with timing.span("cluster.cooccur", device=True):
        return _cooccur(_ShiftJoin(inc), inc.n_codes, chunk)


def _cooccur(sj: _ShiftJoin, n_codes: int, chunk: int):
    keys, weights = [], []
    held = 0

    def reduce():
        with timing.span("cluster.cooccur.reduce"):
            s = torch.cat(keys)
            timing.add("sorted_keys", s.shape[0])
            s, order = torch.sort(s, stable=True)
            u, w = segment_sum_sorted(s, torch.cat(weights)[order])
            keys[:], weights[:] = [u], [w]
            return u.shape[0]

    for d in range(1, sj.D):
        c1, c2, _ = sj.pairs(d)
        keys.append(c1 * n_codes + c2)
        weights.append(torch.ones_like(c1))
        held += c1.shape[0]
        if held > chunk:
            held = reduce()
    if not keys:
        empty = sj.codes.new_zeros(0)
        return empty, empty
    STATS["cooccur_keys"] = reduce()
    return keys[0], weights[0]


def friend_pairs(pair_keys: torch.Tensor, shares: torch.Tensor,
                 min_friend_share: int) -> torch.Tensor:
    """The co-occurrence keys (c1 * n_codes + c2) whose share is at least
    ``min_friend_share``, in their order."""
    return pair_keys[shares >= min_friend_share]


def friend_keys(keys: torch.Tensor, shares: torch.Tensor, n_codes: int,
                min_friend_share: int) -> torch.Tensor:
    """Sorted friend pair keys, both orders, from the c1 < c2 counts."""
    with timing.span("cluster.friends"):
        f1 = friend_pairs(keys, shares, min_friend_share)
        f2 = (f1 % n_codes) * n_codes + f1 // n_codes
        timing.add("sorted_keys", 2 * f1.shape[0])
        return torch.sort(torch.cat([f1, f2])).values


def _forward_positions(inc: Incidence) -> torch.Tensor:
    """Forward-CSR position of every inverted-CSR entry (``inv2fwd``, or the
    dense rank of its (code, kmer) key when the instance was hand-built)."""
    if inc.inv2fwd is not None:
        return inc.inv2fwd
    kmer_of_i = torch.repeat_interleave(
        torch.arange(inc.n_kmers, device=inc.device),
        torch.diff(inc.kmer_offsets))
    return device_dense_ranks(inc.kmer_codes * inc.n_kmers + kmer_of_i)


def _edges(sj: _ShiftJoin, inc: Incidence, fkeys: torch.Tensor):
    """Bipartite (position, friend-rank) edges of every friend pair sharing
    a k-mer, both directions."""
    p_ord = _forward_positions(inc)[sj.pos_old]
    nc, n_f = inc.n_codes, fkeys.shape[0]
    p_parts, f_parts = [], []
    for d in range(1, sj.D):
        c1, c2, i = sj.pairs(d)
        key = c1 * nc + c2
        r1 = torch.clamp(torch.searchsorted(fkeys, key), max=n_f - 1)
        hit = fkeys[r1] == key
        r2 = torch.searchsorted(fkeys, c2 * nc + c1)
        p_parts += [p_ord[i[hit]], p_ord[i[hit] + d]]
        f_parts += [r1[hit], r2[hit]]
    if not p_parts:
        empty = fkeys.new_zeros(0)
        return empty, empty
    return torch.cat(p_parts), torch.cat(f_parts)


def propagate_labels(p_e: torch.Tensor, f_e: torch.Tensor, n_p: int, n_f: int,
                     edge_block: int = _EDGE_BLOCK) -> torch.Tensor:
    """Fixpoint of min-label propagation over position <-> friend edges,
    scattered in blocks of ``edge_block`` edges; returns each position's
    component minimum position (one host sync per round)."""
    dev = p_e.device
    lab = torch.arange(n_p, device=dev)
    E = p_e.shape[0]
    STATS["edges"], STATS["edge_blocks"] = E, -(-E // edge_block)
    STATS["rounds"] = 0
    while True:
        STATS["rounds"] += 1
        with timing.span("cluster.round", device=True):
            new = _round(p_e, f_e, lab, n_p, n_f, edge_block)
            if torch.equal(new, lab):
                return lab
        lab = new


def _round(p_e, f_e, lab, n_p: int, n_f: int, edge_block: int):
    """One round of :func:`propagate_labels`: the new labels."""
    dev, E = p_e.device, p_e.shape[0]
    f_lab = torch.full((n_f,), _BIG, dtype=torch.int64, device=dev)
    for s in range(0, E, edge_block):
        blk = slice(s, s + edge_block)
        f_lab.scatter_reduce_(0, f_e[blk], lab[p_e[blk]], "amin")
    back = torch.full((n_p,), _BIG, dtype=torch.int64, device=dev)
    for s in range(0, E, edge_block):
        blk = slice(s, s + edge_block)
        back.scatter_reduce_(0, p_e[blk], f_lab[f_e[blk]], "amin")
    new = torch.minimum(lab, back)
    new = torch.minimum(new, new[new])   # pointer jump x2
    return torch.minimum(new, new[new])


def canonical_ranks(inc: Incidence, labels: torch.Tensor) -> torch.Tensor:
    """Dense-rank local labels per barcode into canonical cluster ids (a
    component's label is its minimum local index, so ascending label order
    is first-appearance order)."""
    if inc.n_pairs == 0:
        return labels
    K = int(labels.max()) + 1
    base = inc.code_of_pair() * K
    combined = base + labels
    timing.add("sorted_keys", combined.shape[0])
    s = torch.sort(combined).values
    is_new = torch.cat([s.new_ones(1, dtype=torch.bool), s[1:] != s[:-1]])
    return (distinct_below(s, is_new, combined)
            - distinct_below(s, is_new, base))


def cluster_codes_sparse(inc: Incidence, min_friend_share: int = 8,
                         chunk: int = _CHUNK,
                         edge_block: int = _EDGE_BLOCK) -> torch.Tensor:
    """Canonical cluster labels (int64) aligned with the forward CSR:
    bit-equal to ``cluster_barcode_friend`` with no friend cap."""
    STATS.clear()
    if inc.n_pairs == 0:
        return inc.code_kmers.new_zeros(0)
    with timing.span("cluster.cooccur", device=True):
        sj = _ShiftJoin(inc)
        keys, shares = _cooccur(sj, inc.n_codes, chunk)
    fkeys = friend_keys(keys, shares, inc.n_codes, min_friend_share)
    STATS["friend_keys"] = fkeys.shape[0]
    glob = torch.arange(inc.n_pairs, device=inc.device)
    if fkeys.shape[0]:
        with timing.span("cluster.edges", device=True):
            p_e, f_e = _edges(sj, inc, fkeys)
        glob = propagate_labels(p_e, f_e, inc.n_pairs, fkeys.shape[0],
                                edge_block)
    local = glob - inc.code_offsets[inc.code_of_pair()]
    return canonical_ranks(inc, local)
