"""Sorted-run (LSM-style) k-mer count table in torch — the port of
``hash10x_tpu/table/sorted_table.py``.

* state: ``hashes (C,) int64`` ascending with ``INT64_MAX`` pads and
  ``counts (C,) int32``, plus a weighted append buffer ``buf``/``bufw`` of
  (key, multiplicity) entries.  Callers pre-reduce each batch on the device
  (``dedup_weighted`` / ``dedup_pairs_weighted``; their ``_segmented``
  forms reduce S stacked batches at once, each on its own) and append the
  distinct keys only.
* ``append``/``append_pairs`` write the buffer; when it would overflow, the
  table flushes first.
* ``flush_grow`` sorts the buffer, sums the weights of equal keys, merges
  them into the sorted table and re-homes it at the power-of-two capacity
  that keeps occupancy under ``load``: it never spills.  The real-key
  count is read back at every flush and kept exact in ``n_filled``: the
  new keys' boolean selections and the bincount of their places wait for
  the device, ten host waits a flush (``wait.table.flush`` and
  ``wait.table.segment_sum``, ``utils/timing.py``).
* ``merge_counts`` merges outside (key, count) pairs the same way;
  ``prune`` and ``prune_rescue`` drop the error band (``Engine.error_fix``).
* A sort-merge (``flush_grow`` with a non-empty buffer, ``merge_counts``
  included) is the span ``table.flush`` and adds 1 to the counter
  ``flushes`` of the current timer (``utils/timing.py``: the engine's,
  while one of its stages runs; none outside).  Every device sort here adds
  its elements to the counter ``sorted_keys``: a step's dedup sorts run
  inside its CUDA graph, so the step tallies them at capture and adds them
  per replay (``engine_steps``).

Per-batch pre-reductions have a fixed slot count; distinct keys beyond it
are counted exactly in an ``overflow`` tensor that callers check and raise
on, never dropped silently.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import INT64_MAX
from ..utils import timing

__all__ = ["SortedTable", "make_sorted_table", "append", "append_pairs",
           "flush_grow", "grow_buf", "merge_counts", "segment_sum_sorted",
           "dedup_weighted", "dedup_pairs_weighted",
           "dedup_weighted_segmented", "dedup_pairs_weighted_segmented",
           "count_histogram",
           "compact", "prune", "prune_rescue", "lookup_ids"]


@dataclasses.dataclass
class SortedTable:
    hashes: torch.Tensor   # (C,) int64 ascending, INT64_MAX padded
    counts: torch.Tensor   # (C,) int32, 0 at pads
    buf: torch.Tensor      # (Bc,) int64 buffered keys
    bufw: torch.Tensor     # (Bc,) int32 per-key multiplicities
    buf_n: int = 0         # buffered entries
    n_filled: int = 0      # real keys in hashes (exact)

    @property
    def capacity(self) -> int:
        return self.hashes.shape[0]


def make_sorted_table(capacity: int, buf_capacity: int,
                      device: torch.device) -> SortedTable:
    return SortedTable(
        hashes=torch.full((capacity,), INT64_MAX, dtype=torch.int64,
                          device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        buf=torch.full((buf_capacity,), INT64_MAX, dtype=torch.int64,
                       device=device),
        bufw=torch.zeros(buf_capacity, dtype=torch.int32, device=device))


def segment_sum_sorted(s: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distinct keys of the ascending ``s`` (``INT64_MAX`` pads dropped) and
    the int64 sum of ``w`` over each run of equal keys."""
    with timing.wait("table.segment_sum"):
        uniq, run = torch.unique_consecutive(s, return_counts=True)
    tot = torch.cumsum(w.to(torch.int64), 0)[torch.cumsum(run, 0) - 1]
    seg = tot - torch.cat([tot.new_zeros(1), tot[:-1]])
    keep = uniq != INT64_MAX
    with timing.wait("table.segment_sum", 2):
        return uniq[keep], seg[keep]


def flush_grow(t: SortedTable, load: float = 0.6) -> SortedTable:
    """Merge the buffer into the table: sort and reduce the buffer alone,
    add its counts to the keys the table holds, and merge its new keys in
    by position (the table is already sorted, so it is never sorted
    again); the capacity grows (doubling) until the fill is at most
    ``load`` of it.  When the table grows, its append buffer grows to an
    eighth of its capacity, so a table of n keys takes O(log n) flushes,
    each O(n) work plus the sort of one buffer."""
    if t.buf_n == 0:
        return t
    timing.add("flushes")
    with timing.span("table.flush", device=True):
        return _merge_buffer(t, load)


def _merge_buffer(t: SortedTable, load: float) -> SortedTable:
    """:func:`flush_grow` of a non-empty buffer."""
    dev = t.hashes.device
    timing.add("sorted_keys", t.buf_n)
    bk, order = torch.sort(t.buf[:t.buf_n])
    bk, bw = segment_sum_sorted(bk, t.bufw[:t.buf_n][order])
    del order
    n_old = t.n_filled
    th = t.hashes[:n_old]
    at = torch.searchsorted(th, bk)   # insertion points, ascending
    found = th[at.clamp(max=max(n_old - 1, 0))] == bk if n_old else \
        torch.zeros_like(bk, dtype=torch.bool)
    old_counts = t.counts[:n_old].clone()
    with timing.wait("table.flush", 2):
        f_at, f_w = at[found], bw[found]
    old_counts.index_add_(0, f_at, f_w.to(torch.int32))
    del f_at, f_w
    new = ~found
    with timing.wait("table.flush", 3):
        nk, nw, n_at = bk[new], bw[new], at[new]
    n = n_old + nk.shape[0]
    cap = t.capacity
    while n > load * cap:
        cap *= 2
    buf, bufw = t.buf, t.bufw
    if cap > t.capacity and cap // 8 > buf.shape[0]:
        buf = torch.full((cap // 8,), INT64_MAX, dtype=torch.int64,
                         device=dev)
        bufw = torch.zeros(cap // 8, dtype=torch.int32, device=dev)
    hashes = torch.full((cap,), INT64_MAX, dtype=torch.int64, device=dev)
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    # a new key lands after the old keys below it and the new keys before
    # it; an old key after the new keys inserted at or before its position
    with timing.wait("table.flush", 2 if n_at.numel() else 0):
        before = torch.bincount(n_at, minlength=n_old + 1)
    before = torch.cumsum(before, 0)
    pos = torch.arange(n_old, device=dev) + before[:n_old]
    hashes[pos] = th
    counts[pos] = old_counts
    del pos, before, old_counts
    pos = n_at + torch.arange(nk.shape[0], device=dev)
    hashes[pos] = nk
    counts[pos] = nw.to(torch.int32)
    return SortedTable(hashes, counts, buf, bufw, 0, n)


def merge_counts(t: SortedTable, other_h: torch.Tensor,
                 other_w: torch.Tensor) -> SortedTable:
    """Merge outside (key, count) pairs (a loaded checkpoint, an oversized
    barcode's side table) into the table: counts of equal keys add, and the
    capacity grows as in :func:`flush_grow`.  The append buffer is kept."""
    t = flush_grow(t)
    merged = flush_grow(dataclasses.replace(
        t, buf=other_h, bufw=other_w.to(torch.int32), buf_n=other_h.shape[0]))
    return dataclasses.replace(merged, buf=t.buf, bufw=t.bufw)


def grow_buf(t: SortedTable, buf_capacity: int) -> SortedTable:
    """The same table with an append buffer of at least ``buf_capacity``
    entries (buffered entries kept)."""
    if buf_capacity <= t.buf.shape[0]:
        return t
    buf = torch.full((buf_capacity,), INT64_MAX, dtype=torch.int64,
                     device=t.buf.device)
    bufw = torch.zeros(buf_capacity, dtype=torch.int32, device=t.buf.device)
    buf[:t.buf_n] = t.buf[:t.buf_n]
    bufw[:t.buf_n] = t.bufw[:t.buf_n]
    return dataclasses.replace(t, buf=buf, bufw=bufw)


def append_pairs(t: SortedTable, keys: torch.Tensor, weights: torch.Tensor
                 ) -> SortedTable:
    """Buffer pre-reduced (key, multiplicity) pairs (``INT64_MAX`` keys must
    carry weight 0); flushes first when the buffer would overflow."""
    n = keys.shape[0]
    if n > t.buf.shape[0]:
        raise ValueError(f"batch {n} exceeds buffer capacity {t.buf.shape[0]}")
    if t.buf_n + n > t.buf.shape[0]:
        t = flush_grow(t)
    t.buf[t.buf_n:t.buf_n + n] = keys
    t.bufw[t.buf_n:t.buf_n + n] = weights.to(torch.int32)
    return dataclasses.replace(t, buf_n=t.buf_n + n)


def append(t: SortedTable, emissions: torch.Tensor) -> SortedTable:
    """Buffer raw emissions (weight 1 each, ``INT64_MAX`` pads weight 0)."""
    return append_pairs(t, emissions, (emissions != INT64_MAX).to(torch.int32))


def _take_slots(keys: torch.Tensor, weights: torch.Tensor, keep: torch.Tensor,
                slots: int, row=None, S: int = 1):
    """Stable compaction of the kept entries into ``slots`` slots per row
    (``row``: each entry's row of S, non-decreasing, values >= S only past
    the last row; None for one row), pads after, and the exact number of
    kept entries of each row that did not fit (an (S,) device tensor, so
    the caller's loop never syncs)."""
    c = torch.cumsum(keep.to(torch.int64), 0)
    pos = c - 1
    n_out = S * slots
    if row is None:
        dst = torch.where(keep & (pos < slots), pos, n_out)
        overflow = torch.clamp(keep.sum() - slots, min=0).reshape(1)
    else:
        # kept entries before each row's first entry (rows are contiguous:
        # no atomics into S counters)
        first = torch.searchsorted(row, torch.arange(S + 1,
                                                     device=row.device))
        before = torch.cat([c.new_zeros(1), c])[first]
        row = torch.where(keep, row, 0)
        pos = pos - before[row]
        dst = torch.where(keep & (pos < slots), row * slots + pos, n_out)
        overflow = torch.clamp(before[1:] - before[:-1] - slots, min=0)
    # slot n_out takes what is dropped
    out_k = torch.full((n_out + 1,), INT64_MAX, dtype=torch.int64,
                       device=keys.device)
    out_k.scatter_(0, dst, torch.where(keep, keys, INT64_MAX))
    out_w = torch.zeros(n_out + 1, dtype=torch.int32, device=keys.device)
    out_w.scatter_(0, dst, torch.where(keep, weights.to(torch.int32), 0))
    return out_k[:n_out], out_w[:n_out], overflow


def _changes(*cols) -> torch.Tensor:
    """(n - 1,) bool: entry i + 1 differs from entry i in any column (None
    columns skipped)."""
    diff = None
    for c in cols:
        if c is not None:
            d = c[1:] != c[:-1]
            diff = d if diff is None else diff | d
    return diff


def _run_totals(diff: torch.Tensor, counted: torch.Tensor):
    """For sorted entries whose runs of equal keys start where ``diff`` (see
    :func:`_changes`) is set: which entries end a run, and the number of
    ``counted`` entries in the run each such entry ends.

    Each run's starting prefix sum is scattered to its run id and gathered
    back.  The JAX package's running max (``cummax``) is an indexed scan on
    CUDA that took half of the device time of the 800k-read barcodes lane
    on an H100 80GB HBM3 at 700 W."""
    n = counted.shape[0]
    edge = diff.new_ones(1)
    is_first = torch.cat([edge, diff])
    counted = counted.to(torch.int64)
    c = torch.cumsum(counted, 0)
    run_id = torch.cumsum(is_first.to(torch.int64), 0) - 1
    start = c.new_zeros(n + 1)  # slot n takes the non-first writes
    start.scatter_(0, torch.where(is_first, run_id, n), c - counted)
    return torch.cat([diff, edge]), c - start[run_id]


def _fold_rows(flat: torch.Tensor, S: int, key_bits: int):
    """The (row, key) sort key of S stacked rows of real keys below
    ``2**key_bits`` as one int64, ``(row << key_bits) | key`` (pads stay
    ``INT64_MAX``), or None where the row index does not fit above the key
    bits (``key_bits + ceil(log2 S) > 62``): then one more stable sort, by
    row, orders the rows (:func:`_by_row`)."""
    if key_bits + (S - 1).bit_length() > 62:
        return None
    rows = torch.arange(S, device=flat.device)[:, None].expand(
        S, flat.shape[0] // S).reshape(-1)
    return torch.where(flat != INT64_MAX, (rows << key_bits) | flat,
                       INT64_MAX)


def _by_row(order: torch.Tensor, N: int):
    """The permutation ``order`` of stacked rows of N entries stably
    re-sorted by row, and the row of each entry it lists."""
    timing.add("sorted_keys", order.shape[0])
    order = order[torch.argsort(order // N, stable=True)]
    return order, order // N


def dedup_weighted(keyed: torch.Tensor, slots: int):
    """Reduce raw emissions ((N,) int64, ``INT64_MAX`` pads) to
    ``(keys (slots,), weights (slots,) int32, overflow)``: sort, sum equal
    keys, compact.  ``overflow`` counts distinct keys beyond ``slots``."""
    k, w, o = dedup_weighted_segmented(keyed.reshape(1, -1), slots)
    return k, w, o.sum()


def dedup_weighted_segmented(keyed: torch.Tensor, slots: int,
                             key_bits: int = 63):
    """:func:`dedup_weighted` of each row of ``keyed (S, N)`` on its own, as
    S separate calls would give it: ``(keys (S*slots,), weights, overflow
    (S,))`` with row j's entries in slots ``[j*slots, (j+1)*slots)`` and
    ``overflow[j]`` its distinct keys past ``slots``.
    Real keys lie below ``2**key_bits`` (the sort folds the row index in
    where it fits, see :func:`_fold_rows`).  No host sync and no shape that
    depends on the data: a CUDA graph can hold it."""
    S, N = keyed.shape
    flat = keyed.reshape(-1)
    folded = _fold_rows(flat, S, key_bits) if S > 1 else flat
    row = None
    timing.add("sorted_keys", flat.shape[0])
    if folded is None:
        order, row = _by_row(torch.argsort(flat, stable=True), N)
        s = flat[order]
    else:
        s = torch.sort(folded).values
    valid = s != INT64_MAX
    if S > 1 and row is None:
        row, s = s >> key_bits, s & ((1 << key_bits) - 1)
    is_last, run = _run_totals(_changes(s, row), valid)
    return _take_slots(s, run, is_last & valid, slots, row, S)


def dedup_pairs_weighted(flat_h: torch.Tensor, flat_bc: torch.Tensor,
                         slots: int):
    """Barcode-count pre-reduction: distinct (hash, barcode) pairs count
    once, so each returned weight is the hash's number of distinct barcodes
    in this batch (exact across batches when batches are barcode-aligned).
    Rows with barcode < 0 are dropped.  Returns ``(keys (slots,), weights
    (slots,) int32, overflow)``."""
    k, w, o = dedup_pairs_weighted_segmented(flat_h.reshape(1, -1),
                                             flat_bc.reshape(1, -1), slots)
    return k, w, o.sum()


def dedup_pairs_weighted_segmented(flat_h: torch.Tensor, flat_bc: torch.Tensor,
                                   slots: int, key_bits: int = 63):
    """:func:`dedup_pairs_weighted` of each row of ``flat_h``/``flat_bc``
    ``(S, N)`` on its own, laid out as :func:`dedup_weighted_segmented`
    lays out its rows and its overflow (hashes below ``2**key_bits``)."""
    S, N = flat_h.shape
    h, bc = flat_h.reshape(-1), flat_bc.reshape(-1)
    folded = _fold_rows(h, S, key_bits) if S > 1 else h
    # lexicographic (row, hash, barcode) order from stable single-key sorts
    timing.add("sorted_keys", 2 * h.shape[0])
    order = torch.argsort(bc, stable=True)
    row = None
    if folded is None:
        order, row = _by_row(order[torch.argsort(h[order], stable=True)], N)
    else:
        h = folded
        order = order[torch.argsort(h[order], stable=True)]
    hs, bs = h[order], bc[order]
    real = hs != INT64_MAX
    if row is None and S > 1:
        row, hs = hs >> key_bits, hs & ((1 << key_bits) - 1)
    hdiff = _changes(hs, row)
    first = torch.cat([hdiff.new_ones(1), hdiff | (bs[1:] != bs[:-1])])
    is_last, run = _run_totals(hdiff, first & (bs >= 0) & real)
    return _take_slots(hs, run, is_last & real & (run > 0), slots, row, S)


def count_histogram(hashes: torch.Tensor, counts: torch.Tensor,
                    max_count: int = 256) -> torch.Tensor:
    """(max_count + 1,) int64 histogram of resident counts (clipped to
    ``max_count``); bin 0 is always 0."""
    resident = hashes != INT64_MAX
    with timing.wait("table.histogram"):
        c = counts[resident]
    c = torch.clamp(c.to(torch.int64), 0, max_count)
    with timing.wait("table.histogram", 2 if c.numel() else 0):
        hist = torch.bincount(c, minlength=max_count + 1)
    with timing.wait("table.histogram"):   # a host scalar sent to the device
        hist[0] = 0
    return hist


def compact(t: SortedTable, min_count: int = 0, max_count: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hash, count) tensors on the table's device, count-band filtered,
    ascending (positions are canonical ids).  Flush first."""
    if t.buf_n:
        raise ValueError("compact requires a flushed table: t = flush_grow(t)")
    h = t.hashes[:t.n_filled]
    c = t.counts[:t.n_filled]
    keep = c >= min_count
    if max_count:
        keep &= c <= max_count
    with timing.wait("table.compact", 2):
        return h[keep], c[keep]


def _with_keys(t: SortedTable, keep: torch.Tensor) -> SortedTable:
    """The flushed table with only the ``keep`` entries of its first
    ``n_filled`` slots (order kept), at the same capacity."""
    with timing.wait("table.prune"):
        h = t.hashes[:t.n_filled][keep]
    n = h.shape[0]
    hashes = torch.full_like(t.hashes, INT64_MAX)
    counts = torch.zeros_like(t.counts)
    hashes[:n] = h
    with timing.wait("table.prune"):
        counts[:n] = t.counts[:t.n_filled][keep]
    return SortedTable(hashes, counts, t.buf, t.bufw, 0, n)


def prune(t: SortedTable, min_count: int) -> SortedTable:
    """Drop the k-mers with count < ``min_count``.  Flush first."""
    if t.buf_n:
        raise ValueError("prune requires a flushed table")
    return _with_keys(t, t.counts[:t.n_filled] >= min_count)


def prune_rescue(t: SortedTable, occ_h: torch.Tensor, occ_c: torch.Tensor,
                 max_count: int, min_reads: int) -> Tuple[SortedTable, int]:
    """Drop the k-mers with count <= ``max_count`` unless their raw
    occurrence count (``occ_h`` ascending, ``occ_c``) is >= ``min_reads``.
    Returns (table, number rescued).  Flush first."""
    if t.buf_n:
        raise ValueError("prune_rescue requires a flushed table")
    if occ_h.shape[0] == 0:  # nothing can be rescued
        return prune(t, max_count + 1), 0
    c = t.counts[:t.n_filled]
    idx, found = lookup_ids(occ_h, t.hashes[:t.n_filled])
    occ = torch.where(found, occ_c[idx.clamp(min=0)], 0)
    band = c <= max_count
    rescued = band & (c > 0) & (occ >= min_reads)
    out = _with_keys(t, ~band | rescued)
    with timing.wait("table.prune"):
        return out, int(rescued.sum())


def lookup_ids(hashes: torch.Tensor, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary search of ``queries`` in the ascending ``hashes``: (position
    int64 or -1, found bool)."""
    if hashes.shape[0] == 0:
        return (torch.full_like(queries, -1),
                torch.zeros_like(queries, dtype=torch.bool))
    idx = torch.clamp(torch.searchsorted(hashes, queries),
                      max=hashes.shape[0] - 1)
    found = (queries != INT64_MAX) & (hashes[idx] == queries)
    return torch.where(found, idx, -1), found
