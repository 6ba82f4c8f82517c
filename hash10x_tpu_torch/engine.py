"""Single-device pipeline engine: the stateful core behind the CLI — the
port of ``hash10x_tpu/engine.py``.

Commands are methods run in order against one shared state, as in the
reference's command language:

    Engine.count(fqb)        ~ --readFQB       (count pass)
    Engine.histogram()/info()/write_histogram()  ~ --hashDist / --hashInfo
    Engine.error_fix(max)    ~ --errorFix      (error-band prune, optional
                                                read-occurrence rescue)
    Engine.filter(lo, hi)    ~ count-band "good k-mer" selection
    Engine.incidence(fqb)    ~ code-table build (second pass over reads)
    Engine.cluster()         ~ --codeClusters
    Engine.split()           ~ --clusterSplit
    Engine.report(out)       ~ --clusterReport
    Engine.save/load(path)   ~ --writeHash / --readHash (the JAX package's
                                                .npz checkpoint layout)

Everything runs as eager torch code on ``device``; the sketch of every batch
goes through ``kernels.minimizer.sketch`` (the CUDA kernel on a GPU) in any
of its four modes.  Reads are grouped so one barcode never straddles a
batch, which makes per-batch (hash, barcode) dedup exact: counts are
*barcode counts* (``count_mode="barcodes"``) or raw emission counts
(``count_mode="occurrences"``).  A barcode with more reads than a batch
streams alone as a tagged group of batches.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import INT64_MAX
from . import convert
from .cluster import cooccur
from .core.encode import unpack_2bit_torch
from .hashspec import HashSpec
from .io.fqb import Fqb
from .kernels import minimizer
from .table import sorted_table as st
from .table.incidence import (Incidence, combined_key_bits,
                              finalize_combined_pairs,
                              incidence_from_sorted_pairs, pair_keys)
from .utils.dense import device_unique
from .utils.timing import StageTimer

__all__ = ["Engine", "EngineConfig", "coverage_peaks"]


def coverage_peaks(hist: np.ndarray, min_frac: float = 0.05):
    """Local maxima of the lightly smoothed count histogram — the coverage
    peaks the reference prints to guide band selection.  Returns
    [(count, height)] by count."""
    h = hist.astype(np.float64)
    if len(h) < 4:
        return []
    sm = h.copy()
    sm[1:-1] = (h[:-2] + 2 * h[1:-1] + h[2:]) / 4.0
    peaks = []
    hi = sm[1:].max() if len(sm) > 1 else 0
    for c in range(2, len(sm) - 1):
        if sm[c] >= sm[c - 1] and sm[c] > sm[c + 1] and sm[c] >= min_frac * hi:
            peaks.append((c, int(hist[c])))
    return peaks


@dataclass
class EngineConfig:
    spec: HashSpec = field(default_factory=HashSpec)
    mode: str = "minimizer"          # kmer | minimizer | modimizer | syncmer
    modulus: int = 0                 # modimizer modulus (0 => w)
    syncmer_s: int = 0               # syncmer s-mer size (mode == "syncmer")
    table_bits: int = 22             # initial capacity 2^bits (grows)
    batch_reads: int = 4096
    count_mode: str = "barcodes"     # barcodes | occurrences
    min_count: int = 2
    max_count: int = 64
    cluster_mode: str = "friend"     # friend | pair
    min_share: int = 2               # pair-mode support threshold
    min_friend_share: int = 8
    max_friends: int = 0             # friend mode: 0 = uncapped (sparse)
    error_fix_min_reads: int = 0     # >0 (barcodes mode): error_fix rescues
                                     # error-band k-mers with at least this
                                     # many raw occurrences in the lane


class Engine:
    # append-buffer capacity in batches of pre-reduced keys: each flush is
    # one sort of (table + buffer), so flushes stay rare
    _FLUSH_BATCHES = 16

    def __init__(self, cfg: EngineConfig, device, log=sys.stderr):
        if cfg.mode not in minimizer.KERNEL_MODES:
            raise ValueError(f"unknown sketch mode {cfg.mode!r}")
        if cfg.count_mode not in ("barcodes", "occurrences"):
            raise ValueError(f"unknown count mode {cfg.count_mode!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.table: Optional[st.SortedTable] = None
        self.retained_hashes: Optional[torch.Tensor] = None
        self.retained_counts: Optional[torch.Tensor] = None
        self._inc: Optional[Incidence] = None
        self._set_labels(None)
        self.n_reads_counted = 0
        self._read_len = 0
        self._lane_cache = None  # (fqb, device lane, spans)
        self.timer = StageTimer(log, device=self.device)

    # -- incidence and the state derived from it ------------------------------

    @property
    def inc(self) -> Optional[Incidence]:
        return self._inc

    @inc.setter
    def inc(self, v: Optional[Incidence]) -> None:
        """A new incidence invalidates every label-derived result."""
        self._inc = v
        self._set_labels(None)

    def _set_labels(self, labels: Optional[torch.Tensor]) -> None:
        """New labels invalidate the split and the molecule stats."""
        self.cluster_labels = labels
        self.split_inc: Optional[Incidence] = None
        self.split_origin: Optional[torch.Tensor] = None
        self._mol_cache = None  # (sorted code*K+label, sizes, K)

    # -- batching --------------------------------------------------------------

    def _spans(self, fqb: Fqb):
        """Barcode-sorted read order and batch spans (a, b, group) of at most
        ``batch_reads`` reads, boundaries aligned so one barcode never
        straddles a batch; a barcode with more reads than a batch streams
        alone as consecutive spans sharing a group id (None otherwise)."""
        bsz = self.cfg.batch_reads
        order = np.argsort(fqb.barcode_ids, kind="stable")
        bc_all = fqb.barcode_ids[order]
        n = len(bc_all)
        spans = []
        i = 0
        gid = 0
        while i < n:
            j = min(i + bsz, n)
            if j < n:
                # retreat to the start of the straddling barcode
                jb = j
                while jb > i and bc_all[jb - 1] == bc_all[j] and bc_all[j] != -1:
                    jb -= 1
                if jb > i:
                    j = jb
                elif bc_all[j] != -1 and bc_all[i] == bc_all[j]:
                    # oversized barcode: stream it alone as a tagged group
                    e = i + np.searchsorted(bc_all[i:], bc_all[i], "right")
                    gid += 1
                    spans.extend((a, min(a + bsz, e), gid)
                                 for a in range(i, e, bsz))
                    i = e
                    continue
            spans.append((i, j, None))
            i = j
        return order, spans

    def _lane(self, fqb: Fqb):
        """The barcode-sorted lane on the device (packed words as int32,
        lengths, barcode ids, N mask or None) and its batch spans.  Cached
        for the lane last seen, so the incidence pass re-reads nothing."""
        if self._lane_cache is not None and self._lane_cache[0] is fqb:
            return self._lane_cache[1], self._lane_cache[2]
        order, spans = self._spans(fqb)
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a[order])
                                    .view(dtype)).to(dev)
        lane = (put(fqb.packed, np.int32), put(fqb.lengths, np.int32),
                put(fqb.barcode_ids.astype(np.int64), np.int64),
                put(fqb.nmask, np.int32) if fqb.nmask is not None else None)
        self._lane_cache = (fqb, lane, spans)
        return lane, spans

    def _compact_rows(self, P: int) -> int:
        """Kernel compaction width C (0 = dense rows): twice the expected
        per-read emission count plus slack, rounded to 8 (minimizer:
        2P/(w+1); modimizer: P/m; syncmer: P/(k-s+1)).  Per-read counts
        concentrate hard around their mean; overflow is counted exactly and
        raises.  kmer mode emits every position: nothing to compact."""
        cfg = self.cfg
        spec = cfg.spec
        if cfg.mode == "minimizer" and spec.w > 1:
            expected = 2 * P // (spec.w + 1) + 1
        elif cfg.mode == "modimizer":
            expected = P // max(cfg.modulus or spec.w, 1) + 1
        elif cfg.mode == "syncmer" and cfg.syncmer_s:
            expected = P // (spec.k - cfg.syncmer_s + 1) + 1
        else:
            return 0
        c = ((2 * expected + 16 + 7) // 8) * 8
        return c if c < P else 0

    def _batch_slots(self, m: int, P: int, n_flat: int) -> int:
        """Distinct keys one batch of ``m`` reads may buffer.  Minimizer
        mode: the expected emission total plus a quarter and 4096 (per-read
        counts are independent, so the total concentrates around its mean);
        other modes: the full flat width.  Overflow is counted exactly and
        raises."""
        spec = self.cfg.spec
        if self.cfg.mode != "minimizer" or spec.w <= 1:
            return n_flat
        expected = m * (2 * P // (spec.w + 1) + 1)
        slots = expected + expected // 4 + 4096
        return min(n_flat, ((slots + 1023) // 1024) * 1024)

    def _batches(self, fqb: Fqb):
        """Yield the flat (hashes, barcodes) emissions of every batch, its
        number of reads, its count of emissions past the kernel's
        compaction width (a device scalar) and its group id."""
        (packed, lengths, bcs, nmask), spans = self._lane(fqb)
        cfg = self.cfg
        C = self._compact_rows(self._read_len - cfg.spec.k + 1)
        for a, b, gid in spans:
            ln = lengths[a:b]
            codes = unpack_2bit_torch(packed[a:b], self._read_len,
                                      None if nmask is None else nmask[a:b])
            h, _, emit, over = minimizer.sketch(
                cfg.spec, codes, ln, mode=cfg.mode, compact_to=C,
                m=cfg.modulus, syncmer_s=cfg.syncmer_s)
            keyed = torch.where(emit, h, INT64_MAX)
            flat_bc = bcs[a:b, None].expand(-1, h.shape[1])
            yield (keyed.reshape(-1), flat_bc.reshape(-1), b - a, over.sum(),
                   gid)

    def _raise_overflow(self, what: str):
        raise RuntimeError(
            f"{what}: a batch produced more distinct keys than its slots, or "
            "a read more emissions than the kernel's compaction width")

    # -- count pass --------------------------------------------------------------

    def count(self, fqb: Fqb) -> None:
        """Count pass: every batch is sketched, pre-reduced and buffered into
        the count table.  Barcodes mode keys on (hash, distinct-barcode
        count) pairs; an oversized barcode's batches dedup through a side
        table, so each of its distinct hashes enters once.  Occurrences mode
        counts every emission, reads without a barcode included, and its
        groups fold into the normal stream."""
        self._read_len = fqb.read_len
        P = self._read_len - self.cfg.spec.k + 1
        C = self._compact_rows(P)
        bsz = self.cfg.batch_reads
        cap = 1 << self.cfg.table_bits
        full = self._batch_slots(bsz, P, bsz * (C or P))
        buf_cap = max(cap, self._FLUSH_BATCHES * full)
        if self.table is None:
            self.table = st.make_sorted_table(cap, buf_cap, self.device)
        self.table = st.grow_buf(self.table, buf_cap)
        occurrences = self.cfg.count_mode == "occurrences"
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        group, gtab = None, None
        for flat_h, flat_bc, m, sketch_over, gid in self._batches(fqb):
            if group is not None and gid != group:
                self._finish_group(gtab)
                group, gtab = None, None
            slots = self._batch_slots(m, P, flat_h.shape[0])
            if occurrences:
                keys, wts, over = st.dedup_weighted(flat_h, slots)
            else:
                keys, wts, over = st.dedup_pairs_weighted(flat_h, flat_bc,
                                                          slots)
            overflow += sketch_over + over
            if gid is None or occurrences:
                self.table = st.append_pairs(self.table, keys, wts)
                continue
            if gtab is None:
                group = gid
                gtab = st.make_sorted_table(2 * full, 2 * full, self.device)
            gtab = st.append_pairs(gtab, keys, wts)
        if gtab is not None:
            self._finish_group(gtab)
        self.table = st.flush_grow(self.table)
        if int(overflow):
            self._raise_overflow("count")
        self.n_reads_counted += int((fqb.lengths > 0).sum())
        # the table grows instead of spilling: "spilled 0" keeps the JAX
        # package's stage label
        self.timer.stage(f"count: {self.n_reads_counted} reads, "
                         f"{self.table.n_filled} kmers, spilled 0")

    def _finish_group(self, gtab: st.SortedTable) -> None:
        """Move an oversized barcode's side table into the count table: each
        distinct hash of the group counts one barcode."""
        keys, _ = st.compact(st.flush_grow(gtab))
        self.table = st.merge_counts(self.table, keys, torch.ones_like(keys))

    def _flushed(self) -> st.SortedTable:
        if self.table is None:
            raise RuntimeError("no count table (read a lane first)")
        self.table = st.flush_grow(self.table)
        return self.table

    def histogram(self, max_count: int = 256) -> np.ndarray:
        t = self._flushed()
        return st.count_histogram(t.hashes, t.counts, max_count).cpu().numpy()

    def info(self, out=sys.stdout) -> None:
        hist = self.histogram()
        total = int(hist.sum())
        t = self.table
        # the table grows instead of spilling, so its overflow is always 0
        out.write(f"table slots {t.capacity} kmers {t.n_filled} overflow 0\n")
        nz = np.nonzero(hist)[0]
        if len(nz):
            out.write(f"count range [{nz.min()}, {nz.max()}] distinct kmers {total}\n")
        for c, h in coverage_peaks(hist):
            out.write(f"peak count {c} kmers {h}\n")

    def write_histogram(self, out=sys.stdout, max_count: int = 256) -> None:
        hist = self.histogram(max_count)
        for c in np.nonzero(hist)[0]:
            out.write(f"{c}\t{int(hist[c])}\n")

    def _occurrence_counts(self, fqb: Fqb):
        """Sorted (hashes, raw occurrence counts) of the lane under the
        current sketch parameters: a second count pass in occurrences mode
        that leaves the count table and ``n_reads_counted`` as they were."""
        saved = (self.table, self.n_reads_counted, self.cfg.count_mode)
        self.table = None
        try:
            self.cfg.count_mode = "occurrences"
            self.count(fqb)
            return st.compact(self._flushed())
        finally:
            self.table, self.n_reads_counted, self.cfg.count_mode = saved

    def error_fix(self, max_count: int = 1, fqb: Optional[Fqb] = None,
                  min_reads: int = 0) -> None:
        """Error-band correction (``--errorFix``): drop k-mers with count <=
        ``max_count``.  With ``min_reads > 0`` (or the config's
        ``error_fix_min_reads``), loaded reads and barcodes count mode,
        error-band k-mers with at least ``min_reads`` raw occurrences in the
        lane are rescued (kept): a sequencing error is read-unique, a real
        low-coverage k-mer recurs across its molecule's reads."""
        min_reads = min_reads or self.cfg.error_fix_min_reads
        t = self._flushed()
        before = t.n_filled
        rescued = 0
        if min_reads > 0 and fqb is not None \
                and self.cfg.count_mode == "barcodes":
            occ_h, occ_c = self._occurrence_counts(fqb)
            self.table, rescued = st.prune_rescue(
                self._flushed(), occ_h, occ_c, max_count, min_reads)
        else:
            if min_reads > 0:
                why = ("no reads are loaded (rescue needs a second pass "
                       "over the lane; --errorFixReads after --readHash "
                       "alone cannot run it)" if fqb is None else
                       f"count_mode={self.cfg.count_mode!r} has no "
                       "barcode-band semantics to rescue against")
                raise RuntimeError(
                    f"errorFix rescue (min_reads={min_reads}) cannot be "
                    f"honored: {why}; rerun with reads loaded in barcodes "
                    "mode, or drop --errorFixReads for drop-only pruning")
            self.table = st.prune(t, max_count + 1)
        self.timer.stage(
            f"errorFix: dropped {before - self.table.n_filled} kmers with "
            f"count <= {max_count}" + (f", rescued {rescued} with >= "
                                       f"{min_reads} occurrences"
                                       if rescued else ""))

    def filter(self, min_count: int = 0, max_count: int = 0) -> None:
        """Keep the k-mers whose count lies in the band [lo, hi]."""
        lo = min_count or self.cfg.min_count
        hi = max_count or self.cfg.max_count
        self.retained_hashes, self.retained_counts = st.compact(
            self._flushed(), lo, hi)
        self.timer.stage(f"filter [{lo},{hi}]: "
                         f"{self.retained_hashes.shape[0]} kmers kept")

    # -- incidence, clusters, split, report --------------------------------------

    def incidence(self, fqb: Fqb) -> None:
        """Second pass: the deduplicated k-mer x barcode incidence.  Lanes
        whose (barcode, hash) pair fits one int63 key buffer combined keys
        and rank them once at the end; others join each batch against the
        retained set."""
        if self.retained_hashes is None:
            self.filter()
        self._read_len = fqb.read_len
        retained = self.retained_hashes
        n_kmers = retained.shape[0]
        hb = combined_key_bits(self.cfg.spec.k, fqb.n_barcodes)
        P = self._read_len - self.cfg.spec.k + 1
        bsz = self.cfg.batch_reads
        full = self._batch_slots(bsz, P, bsz * (self._compact_rows(P) or P))
        cap = 1 << self.cfg.table_bits
        pt = st.make_sorted_table(cap, max(cap, self._FLUSH_BATCHES * full),
                                  self.device)
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        # group tags do not matter here: the pair table dedups globally
        for flat_h, flat_bc, m, sketch_over, _ in self._batches(fqb):
            if hb:
                ok = (flat_h != INT64_MAX) & (flat_bc >= 0)
                raw = torch.where(ok, (flat_bc << hb) | flat_h, INT64_MAX)
            else:
                raw = pair_keys(retained, flat_h, flat_bc, n_kmers)
            slots = self._batch_slots(m, P, raw.shape[0])
            keys, wts, over = st.dedup_weighted(raw, slots)
            overflow += sketch_over + over
            pt = st.append_pairs(pt, keys, wts)
        if int(overflow):
            self._raise_overflow("incidence")
        pt = st.flush_grow(pt)
        pairs = pt.hashes[:pt.n_filled]
        if hb:
            pairs = finalize_combined_pairs(pairs, retained, n_kmers, hb)
        self.inc = incidence_from_sorted_pairs(pairs, n_kmers, fqb.n_barcodes)
        self.timer.stage(f"incidence: {self.inc.n_pairs} pairs, "
                         f"{self.inc.n_codes} codes x {self.inc.n_kmers} kmers")

    def cluster(self, min_share: int = 0) -> None:
        """Per-barcode molecule clustering (``--codeClusters``) in the
        configured mode: uncapped friend (the sparse pipeline), capped
        friend or pair (``cluster/cooccur.py``)."""
        inc = self.inc
        if inc is None:
            raise RuntimeError("cluster requires incidence (run incidence first)")
        cfg = self.cfg
        labels = cooccur.cluster_codes(
            inc, min_share=min_share or cfg.min_share, mode=cfg.cluster_mode,
            min_friend_share=cfg.min_friend_share,
            max_friends=cfg.max_friends)
        self._set_labels(labels)
        n_cl = 0
        if inc.n_pairs:
            # labels are canonical per-code ranks: molecules = sum(max + 1)
            per_code = torch.zeros(inc.n_codes, dtype=torch.int64,
                                   device=self.device)
            per_code.scatter_reduce_(0, inc.code_of_pair(), labels + 1, "amax")
            n_cl = int(per_code.sum())
        self.timer.stage(f"cluster: {n_cl} molecules over {inc.n_codes} codes")

    def split(self) -> None:
        """Remap (code, cluster) -> new molecule codes (``--clusterSplit``):
        new ids are the dense ranks of the distinct (code, label) pairs in
        ascending order, the oracle's ``split_codes`` numbering."""
        if self.cluster_labels is None:
            raise RuntimeError("split requires clusters")
        inc = self.inc
        if inc.n_pairs == 0:
            self.split_inc = incidence_from_sorted_pairs(
                inc.code_kmers, inc.n_kmers, 0)
            self.split_origin = torch.zeros((0, 2), dtype=torch.int64,
                                            device=self.device)
            self.timer.stage("split: 0 molecule codes")
            return
        K = int(self.cluster_labels.max()) + 1
        comb = inc.code_of_pair() * K + self.cluster_labels
        uniq, new_code, sizes = torch.unique(
            comb, sorted=True, return_inverse=True, return_counts=True)
        self._mol_cache = (uniq, sizes, K)
        pair2 = torch.sort(new_code * inc.n_kmers + inc.code_kmers).values
        self.split_inc = incidence_from_sorted_pairs(
            pair2, inc.n_kmers, uniq.shape[0])
        self.split_origin = torch.stack([uniq // K, uniq % K], dim=1)
        self.timer.stage(f"split: {uniq.shape[0]} molecule codes")

    def report(self, out=sys.stdout) -> None:
        """Cluster report (``--clusterReport``): one line per code with its
        k-mer count, cluster count and cluster sizes."""
        if self.cluster_labels is None:
            raise RuntimeError("report requires clusters")
        inc = self.inc
        if self._mol_cache is None:  # split computes it on the way
            K = int(self.cluster_labels.max()) + 1 if inc.n_pairs else 1
            uniq, sizes = device_unique(
                inc.code_of_pair() * K + self.cluster_labels,
                return_counts=True)
            self._mol_cache = (uniq, sizes, K)
        uniq, sizes, K = self._mol_cache
        n_clusters = torch.bincount(uniq // K, minlength=inc.n_codes)
        _write_report_lines(out, inc.n_codes,
                            torch.diff(inc.code_offsets).tolist(),
                            n_clusters.tolist(), sizes.tolist())
        self.timer.stage(f"report: {inc.n_codes} codes")

    def write_counts(self, out=sys.stdout) -> None:
        """Dump the full (hash, count) table as text, hash-ascending."""
        h, c = st.compact(self._flushed())
        out.write("".join(f"{hv:x}\t{cv}\n"
                          for hv, cv in zip(h.tolist(), c.tolist())))

    def write_clusters(self, out=sys.stdout) -> None:
        """Dump cluster assignments: one line per (code, kmer hash, cluster)."""
        if self.cluster_labels is None:
            raise RuntimeError("write_clusters requires clusters")
        inc = self.inc
        hashes = self.retained_hashes[inc.code_kmers]
        out.write("".join(
            f"{c}\t{h:x}\t{l}\n" for c, h, l in
            zip(inc.code_of_pair().tolist(), hashes.tolist(),
                self.cluster_labels.tolist())))

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path) -> None:
        """Write the analysis state (count table, retained band, incidence,
        cluster labels, split) as the JAX package's ``.npz`` checkpoint:
        uint64 hashes, uint32 counts, int64 offsets, int32 ids and labels,
        and a ``meta`` JSON with version 2."""
        cfg = self.cfg
        meta = {"spec": json.loads(cfg.spec.to_json()), "mode": cfg.mode,
                "count_mode": cfg.count_mode, "n_reads": self.n_reads_counted,
                "version": 2}
        h, c = st.compact(self._flushed())
        parts = {"hashes": convert.keys_to_numpy(h),
                 "counts": convert.to_numpy(c, np.uint32, "counts")}
        if self.retained_hashes is not None:
            parts["retained"] = convert.keys_to_numpy(self.retained_hashes)
            rc = self.retained_counts
            parts["retained_counts"] = (
                np.zeros(0, np.uint32) if rc is None
                else convert.to_numpy(rc, np.uint32, "retained counts"))
        if self.inc is not None:
            parts.update(convert.incidence_to_numpy(self.inc, "inc_"))
            meta["inc_shape"] = [self.inc.n_kmers, self.inc.n_codes]
        if self.cluster_labels is not None:
            parts["cluster_labels"] = convert.to_numpy(
                self.cluster_labels, np.int32, "cluster labels")
        if self.split_inc is not None:
            parts.update(convert.incidence_to_numpy(self.split_inc, "split_"))
            parts["split_origin"] = convert.to_numpy(
                self.split_origin, np.int32, "split origin")
            meta["split_shape"] = [self.split_inc.n_kmers,
                                   self.split_inc.n_codes]
        np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 **parts)

    def load(self, path) -> None:
        """Restore a checkpoint written by either package, replacing the
        current state (never merging into it).  Raises on a spec mismatch."""
        path = str(path)
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        meta = json.loads(bytes(z["meta"]).decode())
        spec = HashSpec(**meta["spec"])
        if spec != self.cfg.spec:
            raise ValueError(f"hash file spec {spec} != engine spec "
                             f"{self.cfg.spec} (tables are only comparable "
                             "with identical k/w/seed)")
        dev = self.device
        h = convert.keys_from_numpy(z["hashes"], dev)
        c = torch.from_numpy(z["counts"].astype(np.int32)).to(dev)
        cap = 1 << self.cfg.table_bits
        self.table = st.merge_counts(st.make_sorted_table(cap, cap, dev), h, c)
        self.n_reads_counted = int(meta["n_reads"])
        self.retained_hashes = (convert.keys_from_numpy(z["retained"], dev)
                                if "retained" in z else None)
        self.retained_counts = (
            torch.from_numpy(z["retained_counts"].astype(np.int32)).to(dev)
            if "retained_counts" in z and len(z["retained_counts"]) else None)
        self.inc = None  # also clears the labels and the split
        if "inc_code_offsets" in z:
            self.inc = convert.incidence_from_npz(z, "inc_",
                                                  meta["inc_shape"], dev)
            if "cluster_labels" in z:
                self._set_labels(torch.from_numpy(
                    z["cluster_labels"].astype(np.int64)).to(dev))
        if "split_code_offsets" in z:
            self.split_inc = convert.incidence_from_npz(
                z, "split_", meta["split_shape"], dev)
            self.split_origin = torch.from_numpy(
                z["split_origin"].astype(np.int64)).to(dev)
        self.timer.stage(f"load: {len(z['hashes'])} kmers"
                         + (f", {self.inc.n_pairs} pairs" if self.inc else "")
                         + (", clusters" if self.cluster_labels is not None
                            else ""))


def _write_report_lines(out, n_codes, n_kmers_per_code, n_clusters,
                        cluster_sizes) -> None:
    """The report text, streamed in bounded chunks of codes."""
    cl_starts = [0] + np.cumsum(n_clusters, dtype=np.int64).tolist()
    CHUNK = 1 << 16
    for c0 in range(0, n_codes, CHUNK):
        c1 = min(c0 + CHUNK, n_codes)
        out.write("".join(
            f"code {c} nKmers {n_kmers_per_code[c]} nClusters {n_clusters[c]} "
            f"sizes {','.join(map(str, cluster_sizes[cl_starts[c]:cl_starts[c + 1]]))}\n"
            for c in range(c0, c1)))
