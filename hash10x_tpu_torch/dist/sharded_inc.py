"""Shard-resident k-mer x barcode incidence — the port of
``hash10x_tpu/dist/sharded_inc.py``.

* :func:`build_sharded_incidence` — one ``all_to_all`` moves the dedup
  owners' sorted pair runs (low-bit shards) into code-range slices: shard s
  owns codes ``[b_s, b_{s+1})`` (``code_range_bounds``), so its ascending run
  is a contiguous slice of the global forward CSR, and a pair's global
  position is ``pair_offsets[s] + local rank``.
* :meth:`ShardedIncidence.build_inverted` — the kmer-major half: each shard
  re-keys its pairs as ``kmer * n_codes + code`` carrying the global forward
  position and routes them to kmer-range owners, which sort (the
  distributed transpose of ``incidence._csr_from_pairs``).
* :meth:`ShardedIncidence.shift_join_arrays` — per shard, the sweep arrays
  of the friend clustering's shift join: k-mer segments by length
  descending, and a segment-length histogram for the host.
* :class:`ShardedLabels`, :func:`canon_labels_sharded`,
  :func:`split_sharded` — cluster labels kept shard-resident, their
  per-molecule statistics, and the split into molecule codes; the host sees
  O(codes + molecules), never O(pairs).

Every structure holds this process's shards only: ``keys[i]`` is shard
``lo + i``'s ascending run of real pair keys (int64).

A routing call is the span ``shard.route`` of the current timer
(``utils/timing.py``) and fills its lanes through
``sharded_sorted.to_lanes``, which counts them; a routing redone with wider
lanes after an overflow adds 1 to ``shard.sweep_retries``; the device sorts
add their elements to ``sorted_keys``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import INT64_MAX
from ..table.incidence import Incidence, incidence_from_sorted_pairs
from ..utils import timing
from . import sharded_sorted as SS
from .group import ShardGroup

__all__ = ["ShardedIncidence", "ShardedLabels", "build_sharded_incidence",
           "canon_labels_sharded", "split_sharded"]


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1), 0).bit_length()


def _route_sorted(group: ShardGroup, rows: List[torch.Tensor],
                  splitters: torch.Tensor, cap: int, what: str,
                  payload: Optional[List[torch.Tensor]] = None):
    """Route ascending per-shard key runs to the owners of the ranges cut by
    ``splitters`` (key >= splitter_{r-1} goes to r or beyond) through
    ``cap``-slot lanes; receivers sort by key.  ``payload`` rides along.
    Returns the received (keys, payload) runs, real entries only; raises
    LaneOverflowError on drops (a collective count)."""
    n = group.n_shards
    width = max([1] + [int(r.shape[0]) for r in rows])
    keys = group.stack_padded(rows, INT64_MAX, width)
    payloads = [(keys, INT64_MAX)]
    if payload is not None:
        payloads.append((group.stack_padded(payload, -1, width), -1))
    b = splitters.expand(keys.shape[0], -1).contiguous()
    starts = torch.cat([
        keys.new_zeros(keys.shape[0], 1), torch.searchsorted(keys, b),
        (keys != INT64_MAX).sum(dim=1, keepdim=True)], dim=1)
    lanes, drop = SS.to_lanes(starts, payloads, cap)
    if SS.host_sum(group, drop):
        raise SS.LaneOverflowError(
            f"{what} dropped pairs (lane overflow)", auto_cap=cap)
    m = group.lane_width(lanes[0], INT64_MAX)
    recv = [group.all_to_all(x, p, m).reshape(group.n_local, n * cap)
            for x, (_, p) in zip(lanes, payloads)]
    out_k, out_p = [], []
    for i in range(group.n_local):
        timing.add("sorted_keys", recv[0][i].shape[0])
        k, order = torch.sort(recv[0][i])
        real = k != INT64_MAX
        with timing.wait("shard.route"):
            out_k.append(k[real])
        if payload is not None:
            with timing.wait("shard.route"):
                out_p.append(recv[1][i][order][real])
    return out_k, out_p


def _route_with_retry(group, rows, splitters, full: int, what: str,
                      payload=None):
    """Expected-load lanes (2x + slack), doubled on overflow up to the
    full width (exact accounting, capped retries)."""
    n = group.n_shards
    cap = full if n == 1 else min(full, 2 * full // n + 4096)
    for attempt in range(4):
        try:
            with timing.span("shard.route", device=True):
                return _route_sorted(group, rows, splitters, cap, what,
                                     payload)
        except SS.LaneOverflowError:
            if cap >= full or attempt == 3:
                raise
            cap = min(full, 2 * cap)
            timing.add("shard.sweep_retries")


def build_sharded_incidence(dt: SS.ShardedSortedTable, n_kmers: int,
                            n_codes: int) -> "ShardedIncidence":
    """Redistribute a finished low-bit pair table into code-range-aligned
    forward-CSR slices (one ``all_to_all``)."""
    g = dt.group
    dt.flush()
    runs = [dt.local_compact(i)[0] for i in range(g.n_local)]
    with timing.wait("shard.incidence"):
        fill = torch.tensor([[max([0] + [int(r.shape[0]) for r in runs])]],
                            device=g.device)
    fill = g.all_reduce(fill, "max")
    with timing.wait("shard.incidence"):
        b1 = _pow2(max(int(fill[0]), 1))
    bounds = SS.code_range_bounds(n_codes, g.n_shards)
    with timing.wait("shard.incidence"):
        splitters = torch.from_numpy(bounds[1:-1] * max(n_kmers, 1)) \
            .to(g.device)
    keys, _ = _route_with_retry(g, runs, splitters, b1,
                                "incidence redistribution")
    return ShardedIncidence(g, keys, g.gather_counts(
        [k.shape[0] for k in keys]), n_kmers, n_codes)


class ShardedIncidence:
    """Code-range-sharded forward pair set and its lazily built kmer-major
    half.  ``keys[i]``: shard ``lo + i``'s ascending code-major pair keys
    (``code * n_kmers + kmer``); ``pair_offsets[s]``: the global forward-CSR
    position of shard s's first pair."""

    def __init__(self, group: ShardGroup, keys: List[torch.Tensor],
                 pair_counts: np.ndarray, n_kmers: int, n_codes: int,
                 code_bounds: Optional[np.ndarray] = None):
        self.group = group
        self.n = group.n_shards
        self.keys = keys
        self.pair_counts = np.asarray(pair_counts, np.int64)
        self.pair_offsets = np.concatenate(
            [[0], np.cumsum(self.pair_counts)]).astype(np.int64)
        self.n_pairs = int(self.pair_counts.sum())
        self.n_kmers = n_kmers
        self.n_codes = n_codes
        self.code_bounds = (np.asarray(code_bounds, np.int64)
                            if code_bounds is not None
                            else SS.code_range_bounds(n_codes, self.n))
        self.inv_keys: Optional[List[torch.Tensor]] = None  # kmer*nc + code
        self.inv_pos: Optional[List[torch.Tensor]] = None   # global fwd pos
        self.kmer_bounds = None
        self._code_offsets = None

    @property
    def code_offsets(self) -> np.ndarray:
        """(n_codes + 1,) int64 global forward-CSR offsets on the host
        (O(n_codes); computed shard-side, a collective)."""
        if self._code_offsets is None:
            self._code_offsets = self._code_offsets_host()
        return self._code_offsets

    def _code_offsets_host(self) -> np.ndarray:
        g, nk = self.group, max(self.n_kmers, 1)
        cb = self.code_bounds
        ncpad = int(max(np.diff(cb).max(initial=0), 0)) + 1
        per = []
        for i, k in enumerate(self.keys):
            s = g.lo + i
            c = torch.arange(ncpad, device=g.device) + int(cb[s])
            per.append(torch.searchsorted(k, c * nk)
                       + int(self.pair_offsets[s]))
        per = g.all_gather_rows(torch.stack(per))
        with timing.wait("shard.incidence"):
            per = per.cpu().numpy()
        out = np.zeros(self.n_codes + 1, np.int64)
        for s in range(self.n):
            c0, c1 = int(cb[s]), int(cb[s + 1])
            out[c0:c1 + 1] = per[s, :c1 - c0 + 1]
        out[self.n_codes] = self.n_pairs
        return out

    def gathered_pairs(self) -> torch.Tensor:
        """Global sorted pair keys on every process (a collective)."""
        rows = self.group.all_gather_rows(
            self.group.stack_padded(self.keys, INT64_MAX), pad=INT64_MAX)
        h = rows.reshape(-1)
        with timing.wait("shard.gather"):
            return h[h != INT64_MAX]

    def to_host(self) -> Incidence:
        """The whole double-CSR Incidence on this process's device (the name
        follows the JAX package: the gathered view for output commands)."""
        return incidence_from_sorted_pairs(self.gathered_pairs(),
                                           self.n_kmers, self.n_codes)

    # -- the kmer-major half (distributed transpose) ---------------------------

    def build_inverted(self) -> None:
        if self.inv_keys is not None:
            return
        g = self.group
        nk, nc = max(self.n_kmers, 1), max(self.n_codes, 1)
        self.kmer_bounds = SS.code_range_bounds(self.n_kmers, self.n)
        with timing.wait("shard.incidence"):
            ksplit = torch.from_numpy(self.kmer_bounds[1:-1] * nc) \
                .to(g.device)
        key2, pos = [], []
        for i, k in enumerate(self.keys):
            timing.add("sorted_keys", k.shape[0])
            k2, order = torch.sort((k % nk) * nc + k // nk)
            key2.append(k2)
            pos.append(int(self.pair_offsets[g.lo + i])
                       + order)
        with timing.wait("shard.incidence"):
            width = torch.tensor([[max([1] + [int(k.shape[0])
                                               for k in self.keys])]],
                                 device=g.device)
        width = g.all_reduce(width, "max")
        with timing.wait("shard.incidence"):
            full = _pow2(max(int(width[0]), 8))
        self.inv_keys, self.inv_pos = _route_with_retry(
            g, key2, ksplit, full, "incidence transpose", payload=pos)

    # -- shift-join sweep arrays -----------------------------------------------

    def shift_join_arrays(self, max_window: int):
        """Per local shard: ``(codes, seg, pos)`` of its k-mer segments in
        length-descending order (key order within a length), padded by W
        (``seg = -1`` pads), the (n, D + 1) histogram of positions per
        segment length (every shard, on the host), W and each shard's
        longest segment; None when no segment exists."""
        self.build_inverted()
        g = self.group
        nc = max(self.n_codes, 1)
        lens_of, D_local = [], 0
        for k2 in self.inv_keys:
            with timing.wait("cluster.shift_join"):
                _, run = torch.unique_consecutive(k2 // nc,
                                                  return_counts=True)
            lens_of.append(run)
            if run.shape[0]:
                with timing.wait("cluster.shift_join"):
                    D_local = max(D_local, int(run.max()))
        with timing.wait("cluster.shift_join"):
            D = torch.tensor([[D_local]], device=g.device)
        D = g.all_reduce(D, "max")
        with timing.wait("cluster.shift_join"):
            D = int(D[0])
        if D <= 0:
            return None
        with timing.wait("cluster.shift_join"):
            Pi = torch.tensor(
                [[max([1] + [int(k.shape[0]) for k in self.inv_keys])]],
                device=g.device)
        Pi = g.all_reduce(Pi, "max")
        with timing.wait("cluster.shift_join"):
            Pi = int(Pi[0])
        W = min(_pow2(max(Pi, 1)), max(_pow2(max_window), _pow2(4 * D)))
        codes, seg, pos, hist = [], [], [], []
        for k2, p, run in zip(self.inv_keys, self.inv_pos, lens_of):
            with timing.wait("cluster.shift_join", 2):
                ln = torch.repeat_interleave(run, run)
            # stable by length descending keeps key order inside a length
            timing.add("sorted_keys", ln.shape[0])
            order = torch.argsort(D - ln, stable=True)
            k2s, lns = k2[order], ln[order]
            new = torch.ones_like(k2s, dtype=torch.bool)
            km = k2s // nc
            new[1:] = km[1:] != km[:-1]
            pad_l = torch.zeros(W, dtype=torch.int64, device=g.device)
            codes.append(torch.cat([k2s % nc, pad_l]))
            seg.append(torch.cat([torch.cumsum(new.to(torch.int64), 0) - 1,
                                  pad_l - 1]))
            pos.append(torch.cat([p[order], pad_l]))
            with timing.wait("cluster.shift_join", 2 if lns.numel() else 0):
                hist.append(torch.bincount(lns, minlength=D + 1)[:D + 1])
        hist = g.all_gather_rows(torch.stack(hist))
        with timing.wait("cluster.shift_join"):
            hist = hist.cpu().numpy()
        Ds = [int(np.nonzero(hist[s])[0].max(initial=0))
              for s in range(self.n)]
        return codes, seg, pos, hist, W, Ds


class ShardedLabels:
    """Canonical cluster labels, shard-resident and position-aligned with a
    ShardedIncidence's forward runs (``canon[i]`` for shard ``lo + i``)."""

    def __init__(self, group: ShardGroup, canon: List[torch.Tensor],
                 pair_counts: np.ndarray, n_molecules: int):
        self.group = group
        self.canon = canon
        self.pair_counts = np.asarray(pair_counts, np.int64)
        self.n_pairs = int(self.pair_counts.sum())
        self.n_molecules = n_molecules
        self._mol_inc = None    # the ShardedIncidence the caches are for
        self._mol_per = None
        self._mol_stats = None

    def to_host(self) -> torch.Tensor:
        """Flat (n_pairs,) int64 labels in global forward-CSR order on this
        process's device (a collective)."""
        g = self.group
        rows = g.all_gather_rows(g.stack_padded(self.canon, -1), pad=-1)
        return torch.cat([rows[s, :self.pair_counts[s]]
                          for s in range(rows.shape[0])])

    def _comb(self, inc_sh: ShardedIncidence, i: int, K: int):
        nk = max(inc_sh.n_kmers, 1)
        return (inc_sh.keys[i] // nk) * K + self.canon[i]

    def _K(self) -> int:
        return int(self.pair_counts.max(initial=0)) + 1

    def molecule_stats(self, inc_sh: ShardedIncidence
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-molecule (code, label, size), ascending by (code, label),
        reduced shard-side: only O(molecules) reaches the host (codes never
        cross shards, and shards own ascending code ranges)."""
        if self._mol_stats is not None and self._mol_inc is inc_sh:
            return self._mol_stats
        g, K = self.group, self._K()
        uniq, cnt = [], []
        for i in range(g.n_local):
            timing.add("sorted_keys", inc_sh.keys[i].shape[0])
            comb = self._comb(inc_sh, i, K)
            with timing.wait("shard.molecules"):
                u, c = torch.unique(comb, sorted=True, return_counts=True)
            uniq.append(u)
            cnt.append(c)
        u = g.all_gather_rows(g.stack_padded(uniq, INT64_MAX), pad=INT64_MAX)
        c = g.all_gather_rows(g.stack_padded(cnt, 0), pad=0)
        u, c = u.reshape(-1), c.reshape(-1)
        real = u != INT64_MAX
        with timing.wait("shard.molecules", 4):
            u, c = u[real].cpu().numpy(), c[real].cpu().numpy()
        self._mol_inc = inc_sh
        self._mol_per = None
        self._mol_stats = (u // K, u % K, c)
        return self._mol_stats

    def mol_counts_per_shard(self, inc_sh: ShardedIncidence) -> np.ndarray:
        """(n,) molecules owned by each shard (a collective)."""
        if self._mol_per is not None and self._mol_inc is inc_sh:
            return self._mol_per
        K = self._K()
        n = []
        for i in range(self.group.n_local):
            comb = self._comb(inc_sh, i, K)
            with timing.wait("shard.molecules"):
                n.append(torch.unique(comb).shape[0])
        per = self.group.gather_counts(n)
        if self._mol_inc is not inc_sh:
            self._mol_stats = None
        self._mol_inc, self._mol_per = inc_sh, per
        return per


def split_sharded(inc_sh: ShardedIncidence, labels_sh: ShardedLabels
                  ) -> ShardedIncidence:
    """(code, cluster) -> new molecule codes, shard-side: molecule ids are
    per-shard dense ranks of the (code, label) keys plus the shard's
    molecule offset, which is the global (code, label)-ascending numbering;
    each shard re-keys its pairs as ``molecule * n_kmers + kmer`` and sorts."""
    g = inc_sh.group
    nk = max(inc_sh.n_kmers, 1)
    per = labels_sh.mol_counts_per_shard(inc_sh)
    moff = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    K = labels_sh._K()
    new_keys = []
    for i, k in enumerate(inc_sh.keys):
        timing.add("sorted_keys", 2 * k.shape[0])   # unique, then sort
        comb = labels_sh._comb(inc_sh, i, K)
        with timing.wait("split"):
            _, rank = torch.unique(comb, sorted=True, return_inverse=True)
        new_keys.append(torch.sort((int(moff[g.lo + i]) + rank) * nk
                                   + k % nk).values)
    return ShardedIncidence(g, new_keys, inc_sh.pair_counts, inc_sh.n_kmers,
                            int(moff[-1]), code_bounds=moff)


def canon_labels_sharded(inc_sh: ShardedIncidence, lab,
                         sharded_lab: bool = False) -> ShardedLabels:
    """Canonical per-barcode cluster ids from global min-position labels,
    shard-side: local label = global min position less the code's first
    global position; canonical id = dense rank of the local label among the
    code's distinct labels (first-appearance numbering).  ``lab`` is the
    replicated (n_pairs,) label vector, or with ``sharded_lab`` a list of
    per-local-shard label runs aligned with ``inc_sh.keys``."""
    g = inc_sh.group
    nk = max(inc_sh.n_kmers, 1)
    canon, n_mol = [], 0
    for i, k in enumerate(inc_sh.keys):
        s = g.lo + i
        P = k.shape[0]
        poff = int(inc_sh.pair_offsets[s])
        glab = lab[i] if sharded_lab else lab[poff:poff + P]
        code = k // nk
        first = torch.searchsorted(code, code)      # the code's first pair
        local = glab - (poff + first)
        K = P + 1
        combined = first * K + local
        base = first * K
        timing.add("sorted_keys", P)
        with timing.wait("cluster.canonical"):
            u, inv = torch.unique(combined, sorted=True, return_inverse=True)
        canon.append(inv - torch.searchsorted(u, base))
        n_mol += u.shape[0]
    with timing.wait("cluster.canonical"):
        total = torch.tensor([n_mol] + [0] * (g.n_local - 1),
                             device=g.device)
    total = SS.host_sum(g, total)
    return ShardedLabels(g, canon, inc_sh.pair_counts, total)
