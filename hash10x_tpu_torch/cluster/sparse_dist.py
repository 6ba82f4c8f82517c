"""Sharded sparse friend clustering — the port of
``hash10x_tpu/cluster/sparse_dist.py`` (``--codeClusters`` with
``--shards``/``--hosts``, uncapped friend mode).

The phases of ``cluster/sparse.py`` spread over a shard group:

1. **Co-occurrence counts.**  The inverted incidence's k-mer segments are
   dealt to shards (longest first, round-robin; or, from a
   :class:`~..dist.sharded_inc.ShardedIncidence`, each shard keeps its own
   k-mer range).  Each shard sweeps its own segments in fixed windows
   (a window: offset ``a``, distance ``d``, width W); the window's pair keys
   ``c1 * n_codes + c2`` route to their owner shard by their low bits through
   one ``all_to_all`` per round and land in per-shard sorted-run tables.
   Lanes are sized to the expected load; a round that overflows them makes
   the sweep run again with doubled lanes.
2. **Friend set.**  Each shard keeps its pairs with share >= the threshold;
   only those are gathered, mirrored to both orders and held by every shard.
3. **Edges.**  A second sweep over each shard's own segments, distance by
   distance (no exchange, so no window), links each forward position to
   the friend ranks of the friends holding the same k-mer; edges stay on
   their shard, as (position, friend rank) blocks of about
   ``_EDGE_BLOCK`` edges (each edge arises once, so nothing dedups or
   sorts them, and no table holds them).
4. **Propagation.**  Labels (global forward positions) are held whole by
   every process.  With one process on CUDA every shard's edge blocks are
   on this card, in one node space: one union-find sweep hooks every
   block into one parent array (``kernels/union_find.py``, no host sync),
   and each position's root is its component's minimum position.  On the
   CPU, and over several processes (gloo), where one process cannot see
   another's edges, labels propagate in rounds: every shard takes the
   minimum over its own edges, block by block, and ``all_reduce(min)``
   merges the shards (the JAX package's ``pmin``), then pointer jumping;
   ``all_reduce(max)`` of a changed flag ends the loop, one host read per
   round.  ``label_block_pairs`` propagates over barcode-aligned blocks of
   positions instead, for lanes whose whole label vector should not be
   held.

Labels equal the single-device ``cluster/sparse.py`` (and the JAX package's
``cluster_codes_sparse_dist``) exactly.

Spans of the current timer (``utils/timing.py``; the engine's while it
clusters), the one-card path's names for the same phases:
``cluster.cooccur`` (1, with the stream clock), ``cluster.friends`` (2),
``cluster.edges`` (3, stream clock) and a ``cluster.round`` per
propagation sweep or round (4, stream clock), with the counters
``cluster.uf_edges`` and ``cluster.uf_hooks`` (the edges the union-find
sweeps took and their links; 0 on the rounds).  The sweep's routing is the
``shard.route`` span and counters of ``dist/sharded_sorted.py``; a sweep
run again with doubled lanes adds 1 to ``shard.sweep_retries``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import INT64_MAX
from ..dist import sharded_sorted as SS
from ..dist.group import ShardGroup
from ..dist.sharded_inc import ShardedIncidence, canon_labels_sharded
from ..kernels import union_find
from ..table import sorted_table as st
from ..table.incidence import Incidence
from ..utils import timing
from .sparse import _BIG, _EDGE_BLOCK, _forward_positions, canonical_ranks

__all__ = ["cluster_codes_sparse_dist", "cooccurrence_counts_dist",
           "friend_keys_dist", "STATS"]

_CHUNK = 1 << 20

# host figures of the last clustering, read by callers that report them:
# friend keys in both orders ("friend_keys"), this process's edges
# ("edges") and their blocks ("edge_blocks"), label blocks
# ("label_blocks") and propagation sweeps or rounds summed over them
# ("rounds")
STATS: dict = {}


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1), 0).bit_length()


class _ShardedShiftJoin:
    """Sweep arrays from a whole Incidence: segments dealt to shards longest
    first, round-robin; this process builds its own shards' arrays."""

    def __init__(self, inc: Incidence, group: ShardGroup, max_window: int,
                 with_positions: bool = False):
        n = group.n_shards
        self.n = n
        with timing.wait("cluster.shift_join"):
            lens = torch.diff(inc.kmer_offsets).cpu().numpy()
        order = np.argsort(-lens, kind="stable")
        per = [order[s::n] for s in range(n)]   # descending within a shard
        self.sls = [lens[p] for p in per]
        self.cums = [np.concatenate([[0], np.cumsum(sl)]) for sl in self.sls]
        self.Ds = [int(sl[0]) if len(sl) else 0 for sl in self.sls]
        maxpairs = max((int(c[-1]) for c in self.cums), default=1)
        self.W = min(_pow2(max(maxpairs, 1)),
                     max(_pow2(max_window), _pow2(4 * max(self.Ds + [1]))))
        dev = group.device
        fwd = _forward_positions(inc) if with_positions else None
        starts_all = inc.kmer_offsets[:-1]
        self.codes, self.seg, self.pos = [], [], []
        pad = torch.zeros(self.W, dtype=torch.int64, device=dev)
        for s in range(group.lo, group.hi):
            with timing.wait("cluster.shift_join", 3):
                sl = torch.from_numpy(self.sls[s]).to(dev)
                cum = torch.from_numpy(self.cums[s]).to(dev)
                idx = torch.from_numpy(per[s]).to(dev)
            starts = starts_all[idx]
            npair = int(self.cums[s][-1])
            with timing.wait("cluster.shift_join", 6):
                pos_old = (torch.arange(npair, device=dev)
                           - torch.repeat_interleave(cum[:-1], sl)
                           + torch.repeat_interleave(starts, sl))
                seg = torch.repeat_interleave(
                    torch.arange(sl.shape[0], device=dev), sl)
            self.codes.append(torch.cat([inc.kmer_codes[pos_old], pad]))
            self.seg.append(torch.cat([seg, pad - 1]))
            self.pos.append(torch.cat([fwd[pos_old], pad])
                            if fwd is not None else None)

    def b(self, s: int, d: int) -> int:
        """Shard s's entries in segments still holding pairs at distance d
        (a prefix: segments of length >= d + 1)."""
        sl = self.sls[s]
        return int(self.cums[s][int(np.searchsorted(-sl, -(d + 1),
                                                    side="right"))])

    def _wins(self, s: int):
        out = []
        for d in range(1, self.Ds[s]):
            b = self.b(s, d)
            a = 0
            while a < b - d:
                out.append((a, d))
                a += self.W - d
        return out

    def rounds(self):
        return _rounds_of(self)

    def total_win_pairs(self) -> int:
        """The co-occurrence key mass: sum of len * (len - 1) / 2."""
        return int(sum(int((sl * (sl - 1) // 2).sum()) for sl in self.sls))


class _ShiftJoinDev:
    """Sweep arrays built shard-side from a ShardedIncidence: the host gets
    only the per-shard segment-length histograms."""

    def __init__(self, inc_sh: ShardedIncidence, max_window: int,
                 with_positions: bool = False):
        self.n = inc_sh.n
        res = inc_sh.shift_join_arrays(max_window)
        if res is None:
            self.Ds, self.W = [0] * self.n, 0
            self.hist = np.zeros((self.n, 1), np.int64)
            self.codes = self.seg = self.pos = None
            return
        self.codes, self.seg, pos, self.hist, self.W, self.Ds = res
        self.pos = pos if with_positions else None

    def b(self, s: int, d: int) -> int:
        """Shard s's positions in segments of length >= d + 1 (a suffix sum
        of its histogram)."""
        return int(self.hist[s][d + 1:].sum())

    def _wins(self, s: int):
        out = []
        for d in range(1, self.Ds[s]):
            b = self.b(s, d)
            a = 0
            while a < b - d:
                out.append((a, d))
                a += self.W - d
        return out

    def rounds(self):
        return _rounds_of(self)

    def total_win_pairs(self) -> int:
        ls = np.arange(self.hist.shape[1], dtype=np.int64)
        return int((self.hist * np.maximum(ls - 1, 0) // 2).sum())


def _rounds_of(sj):
    """Per round, every shard's next window ``(a (n,), d (n,))``; shards
    with none left pad with the d = 0 no-op.  Every process computes the
    same list."""
    wins = [sj._wins(s) for s in range(sj.n)]
    R = max((len(w) for w in wins), default=0)
    for w in wins:
        w.extend([(0, 0)] * (R - len(w)))
    return [(np.array([wins[s][r][0] for s in range(sj.n)], np.int64),
             np.array([wins[s][r][1] for s in range(sj.n)], np.int64))
            for r in range(R)]


def _window(codes, seg, a: int, d: int, W: int):
    """One window's (c1, c2, ok): positions [a, a + W - d) paired with the
    position d further on inside the same segment."""
    cw, sw = codes[a:a + W], seg[a:a + W]
    ok = (sw == torch.roll(sw, -d)) & (sw >= 0) \
        & (torch.arange(W, device=cw.device) < W - d)
    return cw, torch.roll(cw, -d), ok


def _win_keys(codes, seg, a: int, d: int, n_codes: int, W: int):
    c1, c2, ok = _window(codes, seg, a, d, W)
    return torch.where(ok, c1 * n_codes + c2, INT64_MAX)


def _shift_join_of(inc, group: ShardGroup, chunk: int,
                   with_positions: bool = False):
    if isinstance(inc, ShardedIncidence):
        if inc.group.n_shards != group.n_shards:
            raise ValueError("ShardedIncidence shards != cluster shards")
        return _ShiftJoinDev(inc, chunk, with_positions=with_positions)
    return _ShardedShiftJoin(inc, group, chunk, with_positions=with_positions)


def _sweep_tables(group: ShardGroup, cap: int, buf_cap: int):
    return [st.make_sorted_table(cap, buf_cap, group.device)
            for _ in range(group.n_local)]


def _cooccur_table(inc, group: ShardGroup, chunk: int):
    """The sharded co-occurrence sweep: per local shard a flushed sorted
    table of c1 < c2 keys (owner = key low bits) and their shares; None when
    no pair exists."""
    n, nl = group.n_shards, group.n_local
    sj = _shift_join_of(inc, group, chunk)
    if inc.n_pairs == 0 or max(sj.Ds) < 2:
        return None
    W = sj.W
    rounds = sj.rounds()
    # tables grow as they fill (flush_grow): start small
    cap = min(_pow2(max(2 * sj.total_win_pairs() // n, 1 << 12)), 1 << 20)
    none = torch.full((W,), INT64_MAX, dtype=torch.int64,
                      device=group.device)

    def sweep(cap_lane: int):
        recv_width = n * cap_lane
        tables = _sweep_tables(group, cap, _pow2(max(4 * recv_width,
                                                     1 << 12)))
        drops = torch.zeros(nl, dtype=torch.int64, device=group.device)
        for a, d in rounds:
            keys = torch.stack([
                _win_keys(sj.codes[i], sj.seg[i], int(a[s]), int(d[s]),
                          inc.n_codes, W) if d[s] > 0 else none
                for i, s in enumerate(range(group.lo, group.hi))])
            recv, drop = SS.route_low(group, keys, cap_lane)
            drops += drop
            # only the keys go on into the tables: the lanes are mostly pads
            real = recv != INT64_MAX
            with timing.wait("cluster.cooccur", 2):
                got = torch.split(recv[real], real.sum(dim=1).tolist())
            for i in range(nl):
                tables[i] = st.append(tables[i], got[i])
        if SS.host_sum(group, drops):
            raise SS.LaneOverflowError(
                "pair routing dropped keys (lane overflow)",
                auto_cap=cap_lane)
        return [st.flush_grow(t) for t in tables]

    # expected per-destination load of a window is W / n with low-bit
    # routing: 4x headroom, doubled on a skewed window (capped retries; the
    # sweep is recomputed, so a retry is exact)
    cap_lane = min(W, _pow2(4 * W // n + 1024))
    for attempt in range(4):
        try:
            return sweep(cap_lane)
        except SS.LaneOverflowError:
            if cap_lane >= W or attempt == 3:
                raise
            cap_lane = min(W, 2 * cap_lane)
            timing.add("shard.sweep_retries")


def _gather_rows(group: ShardGroup, rows: List[torch.Tensor], pad: int):
    """Every shard's 1-D rows, concatenated in shard order, pads dropped."""
    g = group.all_gather_rows(group.stack_padded(rows, pad), pad=pad)
    g = g.reshape(-1)
    with timing.wait("cluster.friends"):
        return g[g != pad]


def friend_keys_dist(inc, group: ShardGroup, min_friend_share: int,
                     chunk: int = _CHUNK) -> torch.Tensor:
    """Sorted friend keys (both orders) on every process: thresholded
    shard-side, only the survivors are gathered and mirrored."""
    with timing.span("cluster.cooccur", device=True):
        tables = _cooccur_table(inc, group, chunk)
    dev = group.device
    if tables is None:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    with timing.span("cluster.friends"):
        kept = []
        for t in tables:
            h, c = st.compact(t)
            with timing.wait("cluster.friends"):
                kept.append(h[c >= min_friend_share])
        del tables
        k1 = _gather_rows(group, kept, INT64_MAX)
        nc = inc.n_codes
        timing.add("sorted_keys", 2 * k1.shape[0])
        return torch.sort(torch.cat([k1, (k1 % nc) * nc + k1 // nc])).values


def cooccurrence_counts_dist(inc, group: ShardGroup, chunk: int = _CHUNK):
    """Sorted c1 < c2 co-occurrence keys and shares, gathered (the surface
    of ``sparse.cooccurrence_counts``; the cluster path never gathers
    them)."""
    tables = _cooccur_table(inc, group, chunk)
    if tables is None:
        e = torch.zeros(0, dtype=torch.int64, device=group.device)
        return e, e
    parts = [st.compact(t) for t in tables]
    h = _gather_rows(group, [p[0] for p in parts], INT64_MAX)
    c = group.all_gather_rows(group.stack_padded(
        [p[1].to(torch.int64) for p in parts], -1), pad=-1).reshape(-1)
    h, order = torch.sort(h)
    with timing.wait("cluster.friends"):
        return h, c[c >= 0][order]


def _edge_blocks(sj, group: ShardGroup, fkeys, n_codes: int,
                 block: int = _EDGE_BLOCK):
    """The edge sweep, distance by distance over each local shard's own
    segments (no exchange, so no window bounds a step): for a friend pair
    (c1, c2) sharing the k-mer h, the edges (fwd position of (c1, h), rank
    of (c1, c2)) and (fwd position of (c2, h), rank of (c2, c1)).  Per
    local shard a list of (positions, friend ranks) blocks of about
    ``block`` edges."""
    n_f = fkeys.shape[0]
    out = []
    for i, s in enumerate(range(group.lo, group.hi)):
        codes, seg, pos = sj.codes[i], sj.seg[i], sj.pos[i]
        blocks, held, n_held = [], [], 0
        for d in range(1, sj.Ds[s]):
            b = sj.b(s, d)
            if b <= d:
                break
            with timing.wait("cluster.edges"):
                j = torch.nonzero(seg[:b - d] == seg[d:b]).squeeze(1)
            c1, c2 = codes[j], codes[j + d]
            key = c1 * n_codes + c2
            r1 = torch.clamp(torch.searchsorted(fkeys, key), max=n_f - 1)
            hit = fkeys[r1] == key
            with timing.wait("cluster.edges", 4):
                j, r1 = j[hit], r1[hit]
                c1, c2 = c1[hit], c2[hit]
            r2 = torch.searchsorted(fkeys, c2 * n_codes + c1)
            del c1, c2, key, hit
            held.append((torch.cat([pos[j], pos[j + d]]),
                         torch.cat([r1, r2])))
            n_held += 2 * j.shape[0]
            if n_held >= block:
                blocks.append(_joined(held))
                held, n_held = [], 0
        if held:
            blocks.append(_joined(held))
        out.append(blocks)
    return out


def _joined(parts):
    """One (positions, friend ranks) block of a list of them."""
    if len(parts) == 1:
        return parts[0]
    ps, fs = zip(*parts)
    return torch.cat(ps), torch.cat(fs)


def _propagate(group: ShardGroup, edges, n_p: int, n_f: int
               ) -> torch.Tensor:
    """Min-label fixpoint over the position <-> friend edges of every shard
    (``edges[i]``: local shard i's (positions, friend ranks) blocks): each
    position's component minimum.  One process on CUDA holds every
    shard's blocks and takes one union-find sweep over them; the CPU and
    several processes take rounds, labels starting as positions."""
    if group.device.type == "cuda" and group.world == 1:
        return _sweep(group, edges, n_p, n_f)
    timing.add("cluster.uf_edges", 0)
    timing.add("cluster.uf_hooks", 0)
    dev = group.device
    nl = len(edges)
    lab = torch.arange(n_p, device=dev)
    one = torch.ones((1, 1), dtype=torch.int64, device=dev)
    while True:
        STATS["rounds"] = STATS.get("rounds", 0) + 1
        with timing.span("cluster.round", device=True):
            part_f = torch.full((nl, n_f), _BIG, dtype=torch.int64,
                                device=dev)
            for i, blocks in enumerate(edges):
                for p, f in blocks:
                    part_f[i].scatter_reduce_(0, f, lab[p], "amin")
            f_lab = group.all_reduce(part_f, "min")
            del part_f
            part_p = torch.full((nl, n_p), _BIG, dtype=torch.int64,
                                device=dev)
            for i, blocks in enumerate(edges):
                for p, f in blocks:
                    part_p[i].scatter_reduce_(0, p, f_lab[f], "amin")
            del f_lab
            new = torch.minimum(lab, group.all_reduce(part_p, "min"))
            del part_p
            new = torch.minimum(new, new[new])   # pointer jump x2 (labels
            new = torch.minimum(new, new[new])   # are held whole)
            with timing.wait("cluster.round"):
                moved = bool((new != lab).any())
            changed = group.all_reduce(one * moved, "max")
            with timing.wait("cluster.round"):
                changed = int(changed[0])
        if not changed:
            return new
        lab = new


def _sweep(group: ShardGroup, edges, n_p: int, n_f: int) -> torch.Tensor:
    """One union-find kernel call over every local shard's edge blocks."""
    blocks = [b for shard in edges for b in shard]
    n_edges = sum(p.shape[0] for p, _ in blocks)
    if not blocks:
        none = torch.zeros(0, dtype=torch.int64, device=group.device)
        blocks = [(none, none)]
    STATS["rounds"] = STATS.get("rounds", 0) + 1
    with timing.span("cluster.round", device=True):
        lab, hooks = union_find.components_of_blocks(blocks, n_p, n_f)
    timing.add("cluster.uf_edges", n_edges)
    timing.add_device("cluster.uf_hooks", hooks)
    return lab


def _label_blocks(code_offsets: np.ndarray, n_pairs: int, target: int):
    """Barcode-aligned position blocks of about ``target`` pairs."""
    blocks, start = [], 0
    for end in code_offsets[1:].tolist():
        if end - start >= target:
            blocks.append((start, end))
            start = end
    if start < n_pairs:
        blocks.append((start, n_pairs))
    return blocks or [(0, n_pairs)]


def _propagate_blocks(inc, group: ShardGroup, edges, n_f: int, target: int,
                      sharded_out: bool = False):
    """The fixpoint block by block: each block is a barcode-aligned range of
    positions (components never cross barcodes), labels are block-relative
    and each shard contributes those of its edges whose position falls in
    the block.  ``sharded_out`` (a ShardedIncidence): the results land
    in per-shard label runs aligned with ``inc.keys``; else one (n_pairs,)
    vector."""
    offs = inc.code_offsets
    if torch.is_tensor(offs):
        with timing.wait("cluster.blocks"):
            offs = offs.cpu().numpy()
    dev = group.device
    if sharded_out:
        glab = [torch.zeros(k.shape[0], dtype=torch.int64, device=dev)
                for k in inc.keys]
    else:
        glob = torch.empty(inc.n_pairs, dtype=torch.int64, device=dev)
    blocks = _label_blocks(offs, inc.n_pairs, target)
    STATS["label_blocks"] = len(blocks)
    for p0, p1 in blocks:
        mine = []
        for shard in edges:
            mine.append([])
            for p, f in shard:
                with timing.wait("cluster.blocks"):
                    j = torch.nonzero((p >= p0) & (p < p1)).squeeze(1)
                if j.shape[0]:
                    mine[-1].append((p[j] - p0, f[j]))
        lab = p0 + _propagate(group, mine, p1 - p0, n_f)
        del mine
        if not sharded_out:
            glob[p0:p1] = lab
            continue
        for i, k in enumerate(inc.keys):
            s0 = int(inc.pair_offsets[group.lo + i])
            a, b = max(p0, s0), min(p1, s0 + k.shape[0])
            if a < b:
                glab[i][a - s0:b - s0] = lab[a - p0:b - p0]
    return glab if sharded_out else glob


def _local_canon(inc: Incidence, glob: torch.Tensor) -> torch.Tensor:
    return canonical_ranks(inc, glob - inc.code_offsets[inc.code_of_pair()])


def cluster_codes_sparse_dist(inc, group: ShardGroup,
                              min_friend_share: int = 8,
                              chunk: int = _CHUNK, flat: bool = False,
                              label_block_pairs: int = 0,
                              edge_block: int = _EDGE_BLOCK):
    """Sharded ``cluster_codes_sparse``: the same canonical labels.

    ``inc`` is a whole Incidence (labels come back as one int64 tensor
    aligned with its forward CSR, or per-code slices unless ``flat``) or a
    ShardedIncidence (with ``flat``: :class:`ShardedLabels`, shard-resident).
    ``label_block_pairs > 0`` propagates in barcode-aligned blocks of about
    that many pairs; ``edge_block`` is the edges a block of a shard's edges
    holds (:func:`_edge_blocks`)."""
    STATS.clear()
    if isinstance(inc, ShardedIncidence) and not flat:
        inc = inc.to_host()
    sharded = isinstance(inc, ShardedIncidence)
    fkeys = friend_keys_dist(inc, group, min_friend_share, chunk=chunk)
    STATS["friend_keys"] = fkeys.shape[0]
    dev = group.device
    if fkeys.shape[0] == 0 or inc.n_pairs == 0:
        if sharded:   # every pair its own cluster
            return canon_labels_sharded(inc, [
                int(inc.pair_offsets[group.lo + i])
                + torch.arange(k.shape[0], device=dev)
                for i, k in enumerate(inc.keys)], sharded_lab=True)
        canon = _local_canon(inc, torch.arange(inc.n_pairs, device=dev))
    else:
        with timing.span("cluster.edges", device=True):
            sj = _shift_join_of(inc, group, chunk, with_positions=True)
            edges = _edge_blocks(sj, group, fkeys, inc.n_codes, edge_block)
            del sj
        STATS["edges"] = sum(p.shape[0] for e in edges for p, _ in e)
        STATS["edge_blocks"] = sum(len(e) for e in edges)
        n_f = fkeys.shape[0]
        del fkeys
        if label_block_pairs:
            lab = _propagate_blocks(inc, group, edges, n_f,
                                    label_block_pairs, sharded_out=sharded)
        else:
            lab = _propagate(group, edges, inc.n_pairs, n_f)
        del edges
        if sharded:
            return canon_labels_sharded(
                inc, lab, sharded_lab=bool(label_block_pairs))
        canon = _local_canon(inc, lab)
    if flat:
        return canon
    with timing.wait("clusters"):
        offs = inc.code_offsets.tolist()
    return [canon[offs[c]:offs[c + 1]] for c in range(inc.n_codes)]
