"""Sharded sorted-run count tables — the port of
``hash10x_tpu/dist/sharded_sorted.py``.

The shards of a :class:`~.group.ShardGroup` each hold one sorted-run table
(``table/sorted_table.py``).  Hashes route by contiguous VALUE ranges of
their 2k-bit space (:func:`range_splitters`): shard s owns an ascending key
range, so the per-shard sorted tables concatenate into the globally sorted
table with no re-sort, and a key's canonical global rank is its shard's
offset plus its local rank.  Incidence pair keys route by their low bits
instead (``routing="low"``).

One count step over S batches (:class:`SortedCountStep`): the process
sketches its rows of the S global batches with one kernel launch, each
shard sorts each batch's emissions, cuts them into fixed-capacity send
lanes (one per destination shard), one ``all_to_all`` delivers the lanes,
and the owner pre-reduces what it received, batch by batch, into its
table's weighted append buffer.
Lanes keep the JAX package's sizing rule (``lane_cap``): emissions past a
lane's capacity are counted exactly as drops, and a finished pass with
drops raises :class:`LaneOverflowError`, which the engine answers by
counting again with doubled lanes (``--laneCapacity``).

Also the sharded snapshot of the JAX package (per-shard ``.npz`` files and
a JSON manifest, the same files): a snapshot reloads onto any power-of-two
shard count.

What the routing records on the current timer (``utils/timing.py``; the
engine's while one of its stages runs): a routing call (the destination
sort, the lane packing and the exchange: :func:`route_low` and
``SortedCountStep._route_range``, and ``sharded_inc``'s) is the span
``shard.route``, with the stream clock; :func:`to_lanes` adds the lane
slots it fills to ``shard.route_slots`` and the keys it places in them,
pads and drops left out, to ``shard.route_keys``, summed on the device;
the destination sorts add their elements to ``sorted_keys``.  Inside a
CUDA graph's capture the span records nothing and the counters are tallied
for each replay (``engine_steps``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import INT64_MAX
from ..hashspec import HashSpec, U64MAX
from ..kernels import minimizer
from ..table import sorted_table as st
from ..utils import timing
from .group import ShardGroup

__all__ = ["LaneOverflowError", "ShardedSortedTable", "SortedCountStep",
           "range_splitters", "emit_dist_eff", "code_range_bounds",
           "to_lanes", "route_low", "host_sum", "sorted_histogram",
           "gather_sorted_compact", "merge_group", "save_snapshot",
           "load_snapshot"]


class LaneOverflowError(RuntimeError):
    """A routing send lane overflowed its expected-load size (pathological
    skew).  ``auto_cap`` carries the lane size that overflowed: the doubling
    base of the engine's retry."""

    def __init__(self, msg: str, auto_cap: int = 0):
        super().__init__(msg)
        self.auto_cap = int(auto_cap)


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1), 0).bit_length()


def range_splitters(spec: HashSpec, n: int, eff: int = 1) -> np.ndarray:
    """n-1 ascending int64 splitters partitioning the 2k-bit hash value range
    into n contiguous shard ranges of about equal emitted mass: equal ranges
    for uniform emissions (eff = 1), the inverted CDF of a window minimum
    (eff = w + 1, minimizer mode), as in the JAX package."""
    M = 1 << (64 - spec.shift1)
    if eff <= 1:
        return np.array([(M * s) // n for s in range(1, n)], np.int64)
    return np.array([int(M * (1.0 - (1.0 - s / n) ** (1.0 / eff)))
                     for s in range(1, n)], np.int64)


def emit_dist_eff(spec: HashSpec, mode: str) -> int:
    """The emitted-hash distribution exponent for :func:`range_splitters`."""
    return spec.w + 1 if (mode == "minimizer" and spec.w > 1) else 1


def code_range_bounds(n_codes: int, n: int) -> np.ndarray:
    """(n+1,) bounds partitioning [0, n_codes) into n about equal ranges."""
    return np.array([(n_codes * s) // n for s in range(n + 1)], np.int64)


def to_lanes(starts: torch.Tensor,
             payloads: Sequence[Tuple[torch.Tensor, int]], cap: int):
    """Destination-sorted rows -> fixed-capacity send lanes.

    ``starts (rows, n + 1)`` are the per-destination segment bounds of
    each row of the ``(rows, E)`` payloads; returns each payload as
    ``(rows, n, cap)`` lanes (pads past a segment's end) and the exact
    number of entries each row dropped past ``cap``."""
    seg = starts[:, 1:] - starts[:, :-1]                         # (rows, n)
    lane_pos = torch.arange(cap, device=starts.device)
    valid = lane_pos < seg[..., None]                          # (rows, n, cap)
    idx = torch.where(valid, starts[:, :-1, None] + lane_pos, 0)
    nl, n = seg.shape
    timing.add("shard.route_slots", nl * n * cap)
    timing.add_device("shard.route_keys", torch.clamp(seg, max=cap).sum())
    flat_idx = idx.reshape(nl, n * cap)
    lanes = [torch.where(valid, x.gather(1, flat_idx).reshape(nl, n, cap), pad)
             for x, pad in payloads]
    return lanes, torch.clamp(seg - cap, min=0).sum(dim=1)


def _exchange(group: ShardGroup, lanes: torch.Tensor, pad, S: int,
              width: Optional[int] = None) -> torch.Tensor:
    """``(n_local * S, n, cap)`` send lanes (row ``i * S + j``: local shard
    i's lanes of batch j) -> ``(n_local * S, n * cap)`` receipts, row ``i
    * S + j`` what every shard sent shard ``lo + i`` in batch j.  The lanes
    travel as ``(n_local, n, S, cap)``, one lane per batch, so a batch's
    entries never leave its own lane."""
    rows, n, cap = lanes.shape
    nl = rows // S
    send = lanes.reshape(nl, S, n, cap).transpose(1, 2)
    recv = group.all_to_all(send, pad, width)               # (nl, n, S, cap)
    return recv.transpose(1, 2).reshape(rows, n * cap)


def route_low(group: ShardGroup, keys: torch.Tensor, cap: int, S: int = 1):
    """Route ``(n_local * S, E)`` keys (``INT64_MAX`` pads; row ``i * S +
    j``: local shard i's keys of batch j) to the shard of their low bits
    through ``cap``-slot lanes, each batch in lanes of its own: ->
    (received ``(n_local * S, n * cap)`` keys, drops per row)."""
    n = group.n_shards
    with timing.span("shard.route", device=True):
        dest = torch.where(keys != INT64_MAX, keys & (n - 1), n)
        timing.add("sorted_keys", dest.numel())
        ds, order = torch.sort(dest, dim=1, stable=True)
        starts = torch.searchsorted(
            ds, torch.arange(n + 1, device=keys.device)
            .expand(keys.shape[0], -1).contiguous())
        (lanes,), drop = to_lanes(
            starts, [(keys.gather(1, order), INT64_MAX)], cap)
        return _exchange(group, lanes, INT64_MAX, S), drop


class ShardedSortedTable:
    """This process's shards of a sharded count table: one sorted-run table
    per local shard (``rows``), the per-shard drop counts of routing and
    pre-reduction overflow (``drops``), and the emissions past the sketch
    kernel's compaction width (``sketch_over``).

    ``routing="range"``: shard s owns keys in [splitter_{s-1}, splitter_s);
    ``routing="low"``: shard = key & (n - 1)."""

    def __init__(self, group: ShardGroup, capacity: int, buf_capacity: int,
                 spec: Optional[HashSpec] = None, routing: str = "range",
                 range_eff: Optional[int] = None):
        self.group = group
        self.spec = spec
        self.routing = routing
        self.range_eff = range_eff   # None: adopt the first step's
        dev = group.device
        self.rows: List[st.SortedTable] = [
            st.make_sorted_table(capacity, buf_capacity, dev)
            for _ in range(group.n_local)]
        self.drops = torch.zeros(group.n_local, dtype=torch.int64, device=dev)
        self.sketch_over = torch.zeros((), dtype=torch.int64, device=dev)

    @property
    def n_shards(self) -> int:
        return self.group.n_shards

    def flush(self) -> "ShardedSortedTable":
        self.rows = [st.flush_grow(r) for r in self.rows]
        return self

    def local_compact(self, i: int):
        """Shard ``lo + i``'s (hashes, counts), ascending (flush first)."""
        return st.compact(self.rows[i])

    @property
    def hashes(self) -> torch.Tensor:
        """(n_local, C) flushed keys, ``INT64_MAX`` padded (C = widest)."""
        return self.group.stack_padded(
            [self.local_compact(i)[0] for i in range(len(self.rows))],
            INT64_MAX)

    @property
    def counts(self) -> torch.Tensor:
        return self.group.stack_padded(
            [self.local_compact(i)[1] for i in range(len(self.rows))], 0)

    def capacity(self) -> int:
        """The largest shard capacity of every process (a collective)."""
        with timing.wait("shard.table", 2):
            c = torch.tensor([[max(r.capacity for r in self.rows)]],
                             device=self.group.device)
            return int(self.group.all_reduce(c, "max")[0])

    def n_filled(self) -> int:
        """Real keys over every shard (a collective; flush first)."""
        with timing.wait("shard.table"):
            c = torch.tensor([sum(r.n_filled for r in self.rows)],
                             device=self.group.device)
        return host_sum(self.group, c)


class SortedCountStep:
    """The sharded count step, the port of the JAX package's
    ``make_sorted_count_step``.

    A step is stacked (:meth:`stacked`, the JAX package's ``scan_spans``
    on one process and ``scan_stacked`` across processes): this process's
    rows of S global batches (``B_local = batch_reads / world`` rows a
    batch, shard ``lo + i`` taking rows ``[i * per, (i + 1) * per)`` of
    each) in one sketch launch, each (local shard, batch) row routed
    through lanes of its own batch's size and reduced on its own, every
    local shard's batches appended at once (:meth:`append`).  S = 1 is one
    batch a step.

    ``count_mode="barcodes"``: (hash, barcode) pairs route together and are
    pre-reduced at the owner, so a barcode split across shards still counts
    once per batch.  ``pair_retained`` (the sorted retained hashes) or
    ``pair_retained_sharded`` (``(rows, offsets, n_kmers)``: this process's
    range-sharded retained rows, the (n,) global rank of each shard's first
    key, the total) switch the step to the incidence pair set: hop 1 routes
    (hash, barcode) to the hash's range owner, which maps the hash to its
    canonical global rank (local rank + shard offset) and keys the pair as
    ``barcode * n_kmers + rank``; hop 2 routes the pair keys by their low
    bits to their dedup owner.  ``n_codes`` (barcode ids lie below it)
    bounds the pair keys, so the stacked dedup can fold the row index into
    them.  ``compact_to`` is the sketch kernel's per-read compaction width
    (0 = dense rows).  ``emission_cap_factor`` is the JAX step's: its
    per-read compaction width (0 = full rows) sizes the send lanes, so
    ``--laneCapacity`` means the same in both packages."""

    def __init__(self, spec: HashSpec, group: ShardGroup,
                 mode: str = "minimizer", modulus: int = 0,
                 syncmer_s: int = 0, lane_capacity: int = 0,
                 count_mode: str = "occurrences", compact_to: int = 0,
                 pair_retained=None, pair_retained_sharded=None,
                 emission_cap_factor: int = 4, n_codes: int = 0):
        if pair_retained is not None and pair_retained_sharded is not None:
            raise ValueError("pass pair_retained OR pair_retained_sharded")
        self.spec, self.group = spec, group
        self.mode, self.modulus, self.syncmer_s = mode, modulus, syncmer_s
        self.lane_capacity = lane_capacity
        self.count_mode = count_mode
        self.compact_to = compact_to
        self.emission_cap_factor = emission_cap_factor
        n = group.n_shards
        dev = group.device
        self.pair = pair_retained is not None \
            or pair_retained_sharded is not None
        self.routing = "low" if self.pair else "range"
        self.range_eff = emit_dist_eff(spec, mode)
        split = range_splitters(spec, n, self.range_eff)
        with timing.wait("shard.step", 2):
            self.splitters = torch.from_numpy(split).to(dev)
            top = torch.tensor([INT64_MAX], dtype=torch.int64, device=dev)
        self.bounds = torch.cat([self.splitters, top])
        if pair_retained_sharded is not None:
            rows, off, n_kmers = pair_retained_sharded
            self.ret_rows = list(rows)
            self.ret_off = np.asarray(off, np.int64)
            self.n_kmers = int(n_kmers)
        elif pair_retained is not None:
            # shard the retained set by the count table's splitters: each
            # range owner holds only its slice, whose local rank plus the
            # shard offset is the canonical global k-mer id
            with timing.wait("shard.step"):
                ret = pair_retained[pair_retained != INT64_MAX]
            dest = torch.searchsorted(self.splitters, ret, right=True)
            with timing.wait("shard.step", 3 if dest.numel() else 1):
                counts = torch.bincount(dest, minlength=n).cpu().numpy()
            self.ret_off = np.concatenate([[0], np.cumsum(counts)])[:-1] \
                .astype(np.int64)
            with timing.wait("shard.step", group.n_local):
                self.ret_rows = [ret[dest == s]
                                 for s in range(group.lo, group.hi)]
            self.n_kmers = int(ret.shape[0])
        # real keys lie below 2**key_bits: hashes are 2k bits, pair keys
        # below n_codes * n_kmers
        self.key_bits = 2 * spec.k
        if self.pair:
            self.key_bits = ((max(n_codes * self.n_kmers, 1) - 1).bit_length()
                             if n_codes else 63)

    # -- sizing (the JAX package's rules, so --laneCapacity means the same) ----

    def expected_per_read(self, Pp: int) -> int:
        spec, mode = self.spec, self.mode
        if mode == "minimizer" and spec.w > 1:
            return 2 * Pp // (spec.w + 1) + 1
        if mode == "modimizer":
            return Pp // max(self.modulus or spec.w, 1) + 1
        if mode == "syncmer" and self.syncmer_s:
            return Pp // (spec.k - self.syncmer_s + 1) + 1
        return Pp

    def flat_per_read(self, Pp: int) -> int:
        """Emission slots per read the JAX package's step sends from (its
        compaction width at ``emission_cap_factor``; the lane rule is sized
        from it)."""
        cf = self.emission_cap_factor
        if cf and self.mode == "minimizer" and self.spec.w > 1:
            return min(Pp, cf * (2 * Pp // (self.spec.w + 1)) + cf)
        return Pp

    def lane_cap(self, E: int) -> int:
        """Send-lane slots per destination for E emissions of one shard:
        2x the expected per-destination load plus slack (exact at n = 1),
        or ``lane_capacity`` when set."""
        if self.lane_capacity:
            return self.lane_capacity
        n = self.group.n_shards
        if n == 1:
            return max(int(E), 8)
        return max(min(int(E), int(2 * E // n + 4096)), 8)

    def slots_recv(self, batch_reads: int, read_len: int) -> int:
        """Owner-side pre-reduction slots per shard per batch: what one batch
        appends to each shard's buffer."""
        n = self.group.n_shards
        Pp = read_len - self.spec.k + 1
        per = max(batch_reads // n, 1)
        exp = per * self.expected_per_read(Pp)
        raw = n * self.lane_cap(per * self.flat_per_read(Pp))
        if self.pair:
            raw = n * self.lane_cap(raw)
        s = (exp + exp // 4 + 4096) if n == 1 else (2 * exp + 4096)
        return min(raw, ((s + 1023) // 1024) * 1024)

    recv_width = slots_recv

    def auto_lane_cap(self, batch_reads: int, read_len: int) -> int:
        """The auto lane size of a batch of this shape (the retry's base)."""
        per = max(batch_reads // self.group.n_shards, 1)
        return self.lane_cap(per * self.flat_per_read(
            read_len - self.spec.k + 1))

    # -- the step ------------------------------------------------------------

    def _range_starts(self, hs: torch.Tensor) -> torch.Tensor:
        """(n_local, n + 1) destination bounds of ascending rows: range
        routing is monotone in the key, so the sort is the route."""
        b = self.bounds.expand(hs.shape[0], -1).contiguous()
        return torch.cat([hs.new_zeros(hs.shape[0], 1),
                          torch.searchsorted(hs, b)], dim=1)

    def _route_range(self, flat_h, flat_bc, cap, S: int = 1):
        """Hop by hash range of ``(n_local * S, E)`` rows (row ``i * S +
        j``: local shard i's emissions of batch j): -> (received hashes,
        barcodes or None, drops per row) as ``(n_local * S, n * cap)``
        rows."""
        with timing.span("shard.route", device=True):
            timing.add("sorted_keys", flat_h.numel())
            hs, order = torch.sort(flat_h, dim=1, stable=True)
            payloads = [(hs, INT64_MAX)]
            if flat_bc is not None:
                payloads.append((flat_bc.gather(1, order), -1))
            lanes, drop = to_lanes(self._range_starts(hs), payloads, cap)
            m = self.group.lane_width(lanes[0], INT64_MAX)
            recv = [_exchange(self.group, x, p, S, m)
                    for x, (_, p) in zip(lanes, payloads)]
            return recv[0], (recv[1] if flat_bc is not None else None), drop

    def check_table(self, t: ShardedSortedTable) -> None:
        if t.routing != self.routing:
            raise ValueError(f"table routing {t.routing!r} != step routing "
                             f"{self.routing!r}")
        if self.routing == "range":
            if t.range_eff is None:
                t.range_eff = self.range_eff
            elif t.range_eff != self.range_eff:
                raise ValueError(f"table range_eff {t.range_eff} != step "
                                 f"range_eff {self.range_eff}")

    def stacked(self, codes: torch.Tensor, lengths: torch.Tensor,
                bcs: torch.Tensor, S: int):
        """The step over S global batches at once: ``codes (S * B_local,
        L)`` holds this process's rows of each batch, batch-major (pad
        batches are empty rows).  Returns device tensors: keys and
        weights ``(n_local, S * slots)`` (local shard i's batch j in slots
        ``[j * slots, (j + 1) * slots)`` of row i), drops ``(n_local,)``
        (route drops and dedup overflow, each batch's lanes and slots sized
        as one batch's) and the sketch overflow.  With one process nothing
        is read back to the host, so a CUDA graph can hold the step."""
        g = self.group
        nl, n = g.n_local, g.n_shards
        B_local, L = codes.shape[0] // S, codes.shape[1]
        per = B_local // nl
        h, _, emit, over = minimizer.sketch(
            self.spec, codes, lengths, mode=self.mode,
            compact_to=self.compact_to, m=self.modulus,
            syncmer_s=self.syncmer_s)
        R = h.shape[1]
        rows = nl * S

        def shard_major(x):   # (S * nl * per, R) -> rows i * S + j
            return x.reshape(S, nl, per * R).transpose(0, 1).reshape(
                rows, per * R)
        with_bc = self.pair or self.count_mode == "barcodes"
        flat_h = shard_major(torch.where(emit, h, INT64_MAX))
        flat_bc = shard_major(bcs.to(torch.int64)[:, None].expand(-1, R)) \
            if with_bc else None
        cap = self.lane_cap(per * self.flat_per_read(L - self.spec.k + 1))
        slots = self.slots_recv(per * n, L)
        if n == 1:
            rh, rb, drop = flat_h, flat_bc, flat_h.new_zeros(rows)
        else:
            rh, rb, drop = self._route_range(flat_h, flat_bc, cap, S)
        if self.pair:
            rh, rb = rh.reshape(nl, -1), rb.reshape(nl, -1)
            keys = torch.stack([self._pair_keys(i, rh[i], rb[i])
                                for i in range(nl)]).reshape(rows, -1)
            if n > 1:
                keys, drop2 = route_low(g, keys, self.lane_cap(keys.shape[1]),
                                        S)
                drop = drop + drop2
            uh, uw, o = st.dedup_weighted_segmented(keys, slots, self.key_bits)
        elif with_bc:
            uh, uw, o = st.dedup_pairs_weighted_segmented(rh, rb, slots,
                                                          self.key_bits)
        else:
            uh, uw, o = st.dedup_weighted_segmented(rh, slots, self.key_bits)
        return (uh.reshape(nl, S * slots), uw.reshape(nl, S * slots),
                (drop + o).reshape(nl, S).sum(dim=1),
                over.sum(dtype=torch.int64))

    def graph_key(self, S: int, bsz: int, read_len: int) -> tuple:
        """What a CUDA graph of :meth:`stacked` over ``S`` batches of
        ``bsz`` lane rows depends on besides its lane, its (offset, m)
        input and, for a pair step, the retained rows."""
        per = bsz // self.group.n_local
        cap = self.lane_cap(per * self.flat_per_read(read_len - self.spec.k
                                                     + 1))
        return ("sharded", S, bsz, read_len, self.spec, self.mode,
                self.modulus, self.syncmer_s, self.compact_to,
                self.count_mode, self.pair, self.group.n_shards,
                self.key_bits, cap,
                self.slots_recv(per * self.group.n_shards, read_len))

    def append(self, t: ShardedSortedTable, out, S: int,
               n_batches: int) -> None:
        """Buffer the first ``n_batches`` batches (the real ones) of the
        output ``out`` of a stacked step over S batches into each local
        shard of ``t``, and add its drops and sketch overflow."""
        self.check_table(t)
        keys, wts, drops, over = out
        n = n_batches * (keys.shape[1] // S)
        t.drops += drops
        t.sketch_over += over
        for i in range(len(t.rows)):
            t.rows[i] = st.append_pairs(st.grow_buf(t.rows[i], n),
                                        keys[i, :n], wts[i, :n])

    def _pair_keys(self, i: int, rh: torch.Tensor, rb: torch.Tensor):
        """Owner-side canonical pair keys of shard ``lo + i``'s receipts."""
        idx, found = st.lookup_ids(self.ret_rows[i], rh)
        found = found & (rb >= 0)
        rank = int(self.ret_off[self.group.lo + i]) + idx
        return torch.where(found, rb * max(self.n_kmers, 1) + rank, INT64_MAX)

    def finish(self, t: ShardedSortedTable) -> ShardedSortedTable:
        return t.flush()


def host_sum(group: ShardGroup, x: torch.Tensor) -> int:
    """Sum a tensor of this process's over every process (a collective)."""
    s = group.all_reduce(x.to(torch.int64).sum().reshape(1, 1), "sum")
    with timing.wait("shard.host_sum"):
        return int(s[0])


def sorted_histogram(t: ShardedSortedTable, max_count: int = 256
                     ) -> np.ndarray:
    """The count histogram summed over the shards."""
    hists = torch.stack([st.count_histogram(r.hashes, r.counts, max_count)
                         for r in t.flush().rows])
    hists = t.group.all_reduce(hists, "sum")
    with timing.wait("histogram"):
        return hists.cpu().numpy()


def gather_sorted_compact(t: ShardedSortedTable, min_count: int = 0,
                          max_count: int = 0):
    """Every shard's (hash, count) on every process, ascending: with range
    routing a pad-stripping concatenation (shards own ascending ranges), with
    low-bit routing a sort.  A collective."""
    t.flush()
    g = t.group
    h = g.all_gather_rows(t.hashes, pad=INT64_MAX).reshape(-1)
    c = g.all_gather_rows(t.counts, pad=0).reshape(-1)
    keep = h != INT64_MAX
    if min_count:
        keep &= c >= min_count
    if max_count:
        keep &= c <= max_count
    with timing.wait("shard.gather", 2):
        h, c = h[keep], c[keep]
    if t.routing != "range":
        h, order = torch.sort(h, stable=True)
        c = c[order]
    return h, c


def merge_group(t: ShardedSortedTable, side: ShardedSortedTable
                ) -> ShardedSortedTable:
    """Merge an oversized barcode's side table into the main table: each of
    its distinct keys counts one barcode.  Both tables share the range
    splitters, so the merge is shard-local."""
    side.flush()
    drops = host_sum(t.group, side.drops)
    if drops:
        raise LaneOverflowError("oversized-barcode side table dropped "
                                "emissions (lane overflow)")
    t.sketch_over += side.sketch_over
    for i, row in enumerate(side.rows):
        keys, _ = st.compact(row)
        t.rows[i] = st.merge_counts(t.rows[i], keys, torch.ones_like(keys))
    return t


# -- sharded snapshot / restore ---------------------------------------------------

def save_snapshot(t: ShardedSortedTable, path: str) -> None:
    """Per-shard (hash, count) ``.npz`` files and a ``manifest.json``, the
    JAX package's layout (uint64 hashes, uint32 counts).  A collective; the
    coordinator (rank 0) writes."""
    from .. import convert
    t.flush()
    g = t.group
    hashes = g.all_gather_rows(t.hashes, pad=INT64_MAX).cpu().numpy()
    counts = g.all_gather_rows(t.counts, pad=0).cpu().numpy()
    capacity = t.capacity()
    if g.rank != 0:
        return
    os.makedirs(path, exist_ok=True)
    manifest = {"version": 2, "n_shards": t.n_shards,
                "shard_bits": g.shard_bits, "capacity": capacity,
                "routing": t.routing, "range_eff": t.range_eff or 1,
                "spec": json.loads(t.spec.to_json()) if t.spec else None}
    for s in range(t.n_shards):
        keep = hashes[s] != INT64_MAX
        np.savez(os.path.join(path, f"shard_{s:05d}.npz"),
                 hashes=convert.keys_to_numpy(torch.from_numpy(
                     hashes[s][keep])),
                 counts=convert.to_numpy(torch.from_numpy(counts[s][keep]),
                                         np.uint32, "counts"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_snapshot(path: str, group: ShardGroup, capacity: int = 0,
                  buf_capacity: int = 0,
                  expect_spec: Optional[HashSpec] = None
                  ) -> ShardedSortedTable:
    """Restore a snapshot (written by either package) onto ``group``, any
    power-of-two shard count: keys re-route by the manifest's rule."""
    from .. import convert
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    spec = HashSpec(**manifest["spec"]) if manifest["spec"] else None
    if expect_spec is not None and spec is not None and spec != expect_spec:
        raise ValueError(f"snapshot spec {spec} != expected {expect_spec} "
                         "(tables are only comparable with identical "
                         "k/w/seed)")
    hs, cs = [], []
    for s in range(manifest["n_shards"]):
        z = np.load(os.path.join(path, f"shard_{s:05d}.npz"))
        hs.append(z["hashes"].astype(np.uint64))
        cs.append(z["counts"])
    all_h = np.concatenate(hs)
    all_c = np.concatenate(cs)
    all_c = all_c[all_h != np.uint64(U64MAX)]
    dev = group.device
    all_h = convert.keys_from_numpy(all_h, dev)
    n = group.n_shards
    cap = capacity or manifest["capacity"]
    routing = manifest.get("routing", "low")
    range_eff = int(manifest.get("range_eff", 1))
    t = ShardedSortedTable(group, cap, buf_capacity or cap, spec=spec,
                           routing=routing, range_eff=range_eff)
    if routing == "range":
        if spec is None:
            raise ValueError("range-routed snapshot requires a spec")
        dest = torch.searchsorted(torch.from_numpy(
            range_splitters(spec, n, range_eff)).to(dev), all_h, right=True)
    else:
        dest = all_h & (n - 1)
    all_c = torch.from_numpy(all_c.astype(np.int32)).to(dev)
    for i in range(group.n_local):
        sel = dest == group.lo + i
        t.rows[i] = st.merge_counts(t.rows[i], all_h[sel], all_c[sel])
    return t
