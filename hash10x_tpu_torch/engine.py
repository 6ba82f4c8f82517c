"""The pipeline engine: the stateful core behind the CLI — the port of
``hash10x_tpu/engine.py``.

Commands are methods run in order against one shared state, as in the
reference's command language:

    Engine.count(fqb)        ~ --readFQB       (count pass)
    Engine.reset()           clears the analysis state, keeps the lane on
                             the device (a recount skips the copy)
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

Everything runs as torch code on ``device``; the sketch of every batch
goes through ``kernels.minimizer.sketch`` (the CUDA kernel on a GPU) in any
of its four modes.  Reads are grouped so one barcode never straddles a
batch, which makes per-batch (hash, barcode) dedup exact: counts are
*barcode counts* (``count_mode="barcodes"``) or raw emission counts
(``count_mode="occurrences"``).  A barcode with more reads than a batch
streams alone as a tagged group of batches.  The count and incidence passes
send up to ``flush_batches`` batches per device step (``engine_steps``: one
sketch launch over the stacked batches; one CUDA graph replay on a GPU).

With ``n_shards > 1`` (``--shards``; ``--hosts`` spreads the shards over
processes) count, filter, incidence, friend clustering, split and report run
sharded (``dist/``, ``cluster/sparse_dist.py``): the count table, the
retained band, the incidence and the labels stay shard-resident, and whole
views (``table``, ``retained_hashes``, ``inc``, ``cluster_labels``,
``split_inc``) are gathered only when an output command asks for them.
Every gather is a collective, so in a multi-process run every process
enters it (``host_materialize``).  The sharded count and incidence passes
send the same multi-batch steps, each batch routed in lanes of its own: a
CUDA graph replay with one process, eager steps over several (their
exchanges cross the host).

``stats`` holds what the engine's timer (``utils/timing.py``) recorded since
the engine was made or last reset, as flat numbers, none of them read from
the device but the counters summed there (``cluster.uf_hooks``,
``cluster.pair_uf_hooks``, ``cluster.capped_real_cells``,
``cluster.capped_cut`` and the sharded paths' ``shard.route_keys``,
below): the counters ``dispatches`` (multi-batch
steps sent to the device in count and incidence, sharded or not),
``flushes`` (sort-merges of an append buffer into a table during the
engine's stages), ``graph_captures`` (step shapes captured into CUDA
graphs), ``sorted_keys``
(elements put through the main path's device sorts, the lane's barcode
sort included), ``lane_bytes`` (the bytes of the barcode-sorted lane on the
device), ``lane_staged_bytes`` (lane bytes sent through the pinned
staging buffers: the file-order lane on CUDA, 0 on the CPU) and
``host_waits`` (the times a command made the host wait for the device: a
read of a device value, a shape that depends on device data, a copy
between host and device that is not ``non_blocking``; each such statement
is the span ``wait.<site>``, whose ``n`` counts its waits, under the span
its work lies in); and for each span name N, ``N.host_s`` and ``N.n``.
The spans, on the host clock: ``count``, ``filter``, ``incidence``,
``cluster``, ``split``, ``report``, ``histogram`` and ``error_fix`` around
those commands; ``lane`` (its children ``lane.order``, the barcode ids sent in
file order, their stable sort on the device and each read's place in
barcode order; ``lane.copy``, the reads' words, lengths and N masks sent
in file order and put in those places on the device; ``lane.batches``,
the reads per barcode counted on the device and the host's batch spans
from them); ``step`` (one multi-batch step's
host dispatch) and its ``step.capture`` (a CUDA graph's warm-up and
capture); ``table.flush`` (``table/sorted_table.py``); and
``cluster.cooccur``, ``cluster.cooccur.reduce``, ``cluster.friends``,
``cluster.edges`` and ``cluster.round`` (``cluster/sparse.py``), with two
counters held from a friend clustering's propagation on:
``cluster.uf_edges`` and ``cluster.uf_hooks`` (the edges the union-find
kernel swept and the links it made, summed on the device and read with
``stats``; from the one-card path and, with one process on CUDA, from the
sharded path; 0 on the plain rounds, which the CPU and several processes
run).  Pair clustering (``cluster/cooccur.py``) records a batch each
``cluster.pair.lists``, ``cluster.pair.support`` and ``cluster.pair.round``,
and the counters ``cluster.pair_rounds``, ``cluster.pair_uf_hooks`` (the
pair-components kernel's links, summed on the device; 0 on the CPU's
rounds), ``cluster.pair_cells`` and ``cluster.pair_real_cells``.
Capped-friend clustering (``max_friends > 0``) records
``cluster.capped.friends`` once, a batch each ``cluster.capped.member`` and
``cluster.capped.round``, and the counters ``cluster.capped_rounds``,
``cluster.capped_uf_hooks`` (the friend-components kernel's links, summed
on the device; 0 on the CPU's rounds), ``cluster.capped_cells``,
``cluster.capped_real_cells`` and ``cluster.capped_cut`` (the last three
summed on the device).  On CUDA,
``table.flush``, ``cluster.cooccur``, ``cluster.edges``,
``cluster.round``, ``cluster.pair.support``, ``cluster.pair.round`` and
the ``cluster.capped.*`` spans also give
``N.device_s``: the stream's seconds between their marks.  The sharded paths (``n_shards > 1``) record the same names
(``cluster.*`` from ``cluster/sparse_dist.py``), the span ``shard.route``
(every routing outside a CUDA graph, with ``.device_s`` on CUDA) and three
more counters, held from a sharded count or incidence pass on:
``shard.route_keys`` (keys placed in send lanes, summed on the device and
read with ``stats``), ``shard.route_slots`` (the lanes' slots) and
``shard.sweep_retries`` (passes, sweeps and routings run again with wider
lanes after a lane overflow).
"""

from __future__ import annotations

import functools
import json
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import INT64_MAX
from . import convert
from .cluster import cooccur
from .dist import sharded_inc as SI
from .dist import sharded_sorted as DS
from .dist.group import ShardGroup
from .engine_steps import LaneSteps, StepSpec, sharded_step
from .hashspec import HashSpec
from .io.fqb import Fqb
from .kernels import minimizer
from .table import sorted_table as st
from .table.incidence import (Incidence, combined_key_bits,
                              finalize_combined_pairs,
                              incidence_from_sorted_pairs)
from .utils import timing
from .utils.dense import device_unique
from .utils.text import write_report, write_rows
from .utils.timing import StageTimer

__all__ = ["Engine", "EngineConfig", "coverage_peaks"]

# the counters ``Engine.stats`` always holds (0 until counted)
COUNTERS = ("dispatches", "flushes", "graph_captures", "sorted_keys",
            "lane_bytes", "lane_staged_bytes", "host_waits")

# the host-to-device staging of a lane (``_staged``): bytes a staging
# buffer holds, and the buffers in the ring
STAGE_BYTES = 1 << 24
STAGE_RING = 3


def _row_chunks(n: int, row_bytes: int):
    """Chunks (lo, hi, slot) of an array of ``n`` rows of ``row_bytes``:
    whole rows, at most ``STAGE_BYTES`` a chunk, on the staging ring's
    slots in turn."""
    rows = STAGE_BYTES // row_bytes
    for k, lo in enumerate(range(0, n, rows)):
        yield lo, min(lo + rows, n), k % STAGE_RING


def _to_device(a: np.ndarray, device: torch.device, dest=None):
    """Host array ``a`` (uint32 words as int32) on ``device``, its row i at
    row ``dest[i]`` (in file order without ``dest``).  On CUDA through
    pinned staging (``_staged``); on the CPU ``torch.from_numpy``, which
    shares ``a``'s memory in file order."""
    a = np.ascontiguousarray(a)
    src = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
    if device.type == "cuda":
        return _staged(src, device, dest)
    return src if dest is None else \
        torch.empty_like(src).index_copy_(0, dest, src)


def _staged(src: torch.Tensor, device: torch.device, dest=None):
    """``_to_device`` on a CUDA ``device``: each chunk of ``_row_chunks`` is
    copied on the host into its slot, one of ``STAGE_RING`` pinned buffers
    of ``STAGE_BYTES`` from torch's caching host allocator (so later lanes
    of the process reuse them), sent without blocking and, with ``dest``,
    put in place there.  A slot is filled again once the event recorded on
    ``device``'s stream after its last use has passed, so the host's copies
    overlap the transfers.  The bytes sent count in
    ``lane_staged_bytes``."""
    stream = torch.cuda.current_stream(device)
    ring = [(torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True),
             torch.cuda.Event()) for _ in range(STAGE_RING)]
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    row = src.stride(0) * src.element_size()
    for lo, hi, slot in _row_chunks(src.shape[0], row):
        buf, sent = ring[slot]
        sent.synchronize()
        piece = buf[:(hi - lo) * row].view(src.dtype).view(src[lo:hi].shape)
        piece.copy_(src[lo:hi])
        if dest is None:
            out[lo:hi].copy_(piece, non_blocking=True)
        else:
            out.index_copy_(0, dest[lo:hi],
                            piece.to(device, non_blocking=True))
        sent.record(stream)
    timing.add("lane_staged_bytes", src.nbytes)
    return out


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
    n_shards: int = 1                # >1: count, filter, incidence, friend
                                     # clustering, split and report run
                                     # sharded (a power of two)
    lane_capacity: int = 0           # sharded paths: send-lane slots per
                                     # destination shard (0 = auto: expected
                                     # load + slack; grows on overflow)
    cluster_label_blocks: int = 0    # >0: sharded clustering propagates
                                     # labels in barcode-aligned blocks of
                                     # about this many pairs
    flush_batches: int = 16          # batches per device step, and the
                                     # append buffer's capacity in batches
                                     # (each flush is one sort of table +
                                     # buffer, so flushes stay rare)
    kernel_compact: bool = True      # the kernel compacts each read's
                                     # emissions to C rows (_compact_rows);
                                     # per-read overflow raises
    emission_cap_factor: int = 4     # != 0: a minimizer batch buffers its
                                     # expected emissions + 1/4 + 4096
                                     # (_batch_slots); 0: the full width.
                                     # Overflow is counted and raises


def _span(name: str):
    """Run the method inside the span ``name`` of the engine's timer."""
    def deco(method):
        @functools.wraps(method)
        def wrapped(self, *args, **kwargs):
            with self.timer.span(name):
                return method(self, *args, **kwargs)
        return wrapped
    return deco


class Engine:
    def __init__(self, cfg: EngineConfig, device, log=sys.stderr):
        if cfg.mode not in minimizer.KERNEL_MODES:
            raise ValueError(f"unknown sketch mode {cfg.mode!r}")
        if cfg.count_mode not in ("barcodes", "occurrences"):
            raise ValueError(f"unknown count mode {cfg.count_mode!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self._group: Optional[ShardGroup] = None
        self._global_n_barcodes = 0   # multi-process --readFQBShard lanes
        self._read_len = 0
        # (fqb, batch size, device lane, spans, the lane's LaneSteps)
        self._lane_cache = None
        # one process's --readFQBShard lane: (fqb, rows per batch, global-id
        # lane, schedule, global barcode count, the lane's LaneSteps)
        self._shard_lane_cache = None
        self.timer = StageTimer(log, device=self.device)
        self.reset()

    def reset(self) -> None:
        """Clear the analysis state (count table, retained band, incidence,
        labels, split, read count, ``stats``), plain and sharded.  The lane
        cached on the device and the shard group stay: a recount of the
        same lane copies nothing to the device, and a multi-process run
        does not join again."""
        self.table: Optional[st.SortedTable] = None
        # sharded state (n_shards > 1): count table, retained band (rows,
        # counts, (n,) global offsets, total), incidence, labels, split
        self._dt: Optional[DS.ShardedSortedTable] = None
        self.retained_hashes = None   # and the sharded band
        self.retained_counts = None
        self.inc = None   # and the sharded incidence, labels, split
        self.n_reads_counted = 0
        self.timer.clear()

    @property
    def stats(self) -> dict:
        """The counters and span totals recorded since the engine was made
        or last reset (see the module docstring).  A span's ``device_s``
        holds the spans whose end the stream has passed: read it after a
        synchronisation to have them all."""
        return {**dict.fromkeys(COUNTERS, 0), **self.timer.stats()}

    # -- whole views of the (possibly sharded) state -------------------------------

    @property
    def retained_hashes(self) -> Optional[torch.Tensor]:
        """The count band's hashes, ascending (gathered once from the shards
        on the sharded path)."""
        if self._retained is None and self._ret_sh is not None:
            self._gather_retained()
        return self._retained

    @retained_hashes.setter
    def retained_hashes(self, v) -> None:
        self._retained = v
        self._ret_sh = None

    @property
    def retained_counts(self) -> Optional[torch.Tensor]:
        if self._retained_counts is None and self._ret_sh is not None:
            self._gather_retained()
        return self._retained_counts

    @retained_counts.setter
    def retained_counts(self, v) -> None:
        self._retained_counts = v

    def _gather_retained(self) -> None:
        """Shards own ascending ranges: the gather is a concatenation."""
        rows, crows, _, _ = self._ret_sh
        g = self._shard_group()
        h = g.all_gather_rows(g.stack_padded(rows, INT64_MAX),
                              pad=INT64_MAX).reshape(-1)
        c = g.all_gather_rows(g.stack_padded(crows, -1), pad=-1).reshape(-1)
        with timing.wait("shard.gather", 2):
            self._retained = h[h != INT64_MAX]
            self._retained_counts = c[c >= 0]

    @property
    def inc(self) -> Optional[Incidence]:
        """The whole incidence (gathered once from the shards on the sharded
        path)."""
        if self._inc is None and self._inc_sh is not None:
            self._inc = self._inc_sh.to_host()
        return self._inc

    @inc.setter
    def inc(self, v: Optional[Incidence]) -> None:
        """A new incidence invalidates every label-derived result."""
        self._inc = v
        self._inc_sh = None
        self._set_labels(None)

    def _set_inc_sh(self, v: SI.ShardedIncidence) -> None:
        self._inc = None
        self._inc_sh = v
        self._set_labels(None)

    def _inc_any(self):
        return self._inc_sh if self._inc_sh is not None else self._inc

    @property
    def cluster_labels(self) -> Optional[torch.Tensor]:
        """Flat labels aligned with the forward CSR (gathered once from the
        shards on the sharded path)."""
        if self._labels is None and self._labels_sh is not None:
            self._labels = self._labels_sh.to_host()
        return self._labels

    def _has_labels(self) -> bool:
        return self._labels is not None or self._labels_sh is not None

    @property
    def clusters(self) -> Optional[List[torch.Tensor]]:
        """Per-code views of the flat labels: entry c holds the labels of
        barcode c's k-mers (None before clustering)."""
        labels = self.cluster_labels
        if labels is None:
            return None
        with timing.wait("clusters"):
            offs = self.inc.code_offsets.tolist()
        return [labels[offs[c]:offs[c + 1]] for c in range(len(offs) - 1)]

    @property
    def split_inc(self) -> Optional[Incidence]:
        if self._split_inc is None and self._split_inc_sh is not None:
            self._split_inc = self._split_inc_sh.to_host()
        return self._split_inc

    @split_inc.setter
    def split_inc(self, v: Optional[Incidence]) -> None:
        self._split_inc = v
        self._split_inc_sh = None

    def _set_labels(self, labels) -> None:
        """New labels (a tensor, ShardedLabels or None) invalidate the split
        and the molecule stats."""
        if isinstance(labels, SI.ShardedLabels):
            self._labels, self._labels_sh = None, labels
        else:
            self._labels, self._labels_sh = labels, None
        self.split_inc = None
        self.split_origin: Optional[torch.Tensor] = None
        self._mol_cache = None  # (sorted code*K+label, sizes, K)

    def host_materialize(self) -> None:
        """Gather every whole view an output command may read.  Gathers are
        collectives: in a multi-process run every process enters this before
        the coordinator alone writes."""
        self._flushed()
        for view in ("retained_hashes", "inc", "cluster_labels", "split_inc"):
            getattr(self, view)

    # -- batching --------------------------------------------------------------

    @staticmethod
    def _batch_spans(counts: np.ndarray, bsz: int):
        """Batch spans (a, b, group) over the barcode-sorted lane whose
        barcode id i has ``counts[i + 1]`` reads (``counts[0]``: the reads
        without a barcode, id -1, which sort first and split anywhere): at
        most ``bsz`` reads a batch, boundaries aligned so one barcode never
        straddles a batch; a barcode with more reads than a batch streams
        alone as consecutive spans sharing a group id (None otherwise)."""
        ends = np.cumsum(counts)         # id r - 1 ends at ends[r]
        n, m = int(ends[-1]), int(counts[0])
        spans = []
        i = 0
        gid = 0
        while i < n:
            j = i + bsz
            if j >= n:
                spans.append((i, n, None))
                break
            if j >= m:
                # retreat to the start of the barcode that j falls in
                r = int(np.searchsorted(ends, j, "right"))
                e = int(ends[r])
                s = e - int(counts[r])
                if s <= i:
                    # oversized barcode: stream it alone as a tagged group
                    gid += 1
                    spans.extend((a, min(a + bsz, e), gid)
                                 for a in range(i, e, bsz))
                    i = e
                    continue
                j = s
            spans.append((i, j, None))
            i = j
        return spans

    def _lane(self, fqb: Fqb, bsz: int = 0):
        """The barcode-sorted lane on the device (packed words as int32,
        lengths, barcode ids as int64, N mask or None) and its batch spans
        of ``bsz`` reads (``_batch_spans``).  The barcode ids go to the
        device in file order (``_to_device``) and a stable sort there gives
        each read its place in barcode order; the other arrays go in file
        order and land in those places, so the set-up holds little beyond
        the lane.  The reads per barcode, counted there, come back for the
        spans.  Cached for the lane last seen, with its multi-batch steps
        (``_steps``), so the incidence pass re-reads nothing."""
        bsz = bsz or self.cfg.batch_reads
        c = self._lane_cache
        if c is not None and c[0] is fqb and c[1] == bsz:
            return c[2], c[3]
        dev = self.device
        with timing.span("lane"):
            with timing.span("lane.order"):
                bcs, order = torch.sort(_to_device(
                    np.asarray(fqb.barcode_ids, np.int32), dev), stable=True)
                timing.add("sorted_keys", order.shape[0])
                bcs = bcs.long()
                dest = torch.empty_like(order).scatter_(
                    0, order, torch.arange(order.shape[0], device=dev))
                del order
            with timing.span("lane.copy"):
                lane = (_to_device(fqb.packed, dev, dest),
                        _to_device(fqb.lengths, dev, dest), bcs,
                        None if fqb.nmask is None
                        else _to_device(fqb.nmask, dev, dest))
                del dest
            with timing.span("lane.batches"):
                with timing.wait("lane.batches", 2 if bcs.numel() else 0):
                    counts = torch.bincount(bcs + 1, minlength=1)
                with timing.wait("lane.batches"):
                    counts = counts.cpu().numpy()
                spans = self._batch_spans(counts, bsz)
                del counts
            timing.add("lane_bytes",
                       sum(x.nbytes for x in lane if x is not None))
        self._lane_cache = (fqb, bsz, lane, spans, LaneSteps(lane))
        return lane, spans

    def _lane_steps(self, fqb: Fqb):
        """The lane's batch spans and its steps (``engine_steps``)."""
        _, spans = self._lane(fqb)
        return spans, self._lane_cache[4]

    def _compact_rows(self, P: int) -> int:
        """Kernel compaction width C (0 = dense rows, and always with
        ``kernel_compact`` off): twice the expected per-read emission count
        plus slack, rounded to 8 (minimizer: 2P/(w+1); modimizer: P/m;
        syncmer: P/(k-s+1)).  Per-read counts concentrate hard around their
        mean; overflow is counted exactly and raises.  kmer mode emits every
        position: nothing to compact."""
        cfg = self.cfg
        spec = cfg.spec
        if not cfg.kernel_compact:
            return 0
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

    def _batch_slots(self, bsz: int, P: int, n_flat: int) -> int:
        """Distinct keys one batch of ``bsz`` reads may buffer (the JAX
        engine's ``_batch_slots``/``_dedup_slots``).  Minimizer mode with
        ``emission_cap_factor`` != 0: the expected emission total plus a
        quarter and 4096 (per-read counts are independent, so the total
        concentrates around its mean); otherwise the full flat width.
        Overflow is counted exactly and raises."""
        spec = self.cfg.spec
        if (not self.cfg.emission_cap_factor or self.cfg.mode != "minimizer"
                or spec.w <= 1):
            return n_flat
        expected = bsz * (2 * P // (spec.w + 1) + 1)
        slots = expected + expected // 4 + 4096
        return min(n_flat, ((slots + 1023) // 1024) * 1024)

    def _step_groups(self, spans, split_groups: bool):
        """The spans as steps of at most ``flush_batches`` batches: (spans
        [(a, b)], group id).  Consecutive spans form a run sent in groups of
        up to S; with ``split_groups`` (the barcodes-mode count) each batch
        of an oversized barcode is a step of its own that carries its group
        id and ends the run, as in the JAX engine's count loop
        (``hash10x_tpu/engine.py:1070-1121``)."""
        S = max(1, self.cfg.flush_batches)
        run = []
        for a, b, gid in spans:
            if gid is None or not split_groups:
                run.append((a, b))
                continue
            for i in range(0, len(run), S):
                yield run[i:i + S], None
            run = []
            yield [(a, b)], gid
        for i in range(0, len(run), S):
            yield run[i:i + S], None

    def _step(self, steps: LaneSteps, grp, keying: str, key_bits: int,
              retained=None, **kw):
        """One multi-batch step (``engine_steps``) over the spans ``grp``:
        (keys, weights) of its real batches, ``slots`` entries each, and
        its overflow (a device scalar).  S is ``len(grp)`` rounded up to a
        power of two, so a pass makes at most log2(flush_batches) + 1 step
        shapes; the pad batches are empty."""
        cfg = self.cfg
        with timing.span("step"):
            S = 1 << (len(grp) - 1).bit_length()
            om = np.zeros((2, S), np.int64)
            om[:, :len(grp)] = np.array([(a, b - a) for a, b in grp]).T
            ss = StepSpec(S, cfg.batch_reads, self._read_len, cfg.spec,
                          cfg.mode, cfg.modulus, cfg.syncmer_s,
                          *self._batch_shape(), keying, key_bits, **kw)
            self.timer.add("dispatches")
            keys, wts, over = steps(ss, om, retained)
            n = len(grp) * ss.slots
            return keys[:n], wts[:n], over

    def _batch_shape(self):
        """(C, slots) of this lane's batches: the kernel's compaction width
        and the entries each batch buffers."""
        P = self._read_len - self.cfg.spec.k + 1
        C = self._compact_rows(P)
        bsz = self.cfg.batch_reads
        return C, self._batch_slots(bsz, P, bsz * (C or P))

    def _raise_overflow(self, what: str):
        raise RuntimeError(
            f"{what}: overflow: a batch produced more distinct keys than its "
            "slots, or a read more emissions than the kernel's compaction "
            "width (emission_cap_factor=0 gives full-width slots, "
            "kernel_compact=False dense rows)")

    # -- count pass --------------------------------------------------------------

    @_span("count")
    def count(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Count pass: steps of up to ``flush_batches`` batches sketch,
        pre-reduce and buffer into the count table.  Barcodes mode keys on
        (hash, distinct-barcode count) pairs; an oversized barcode's batches
        go one per step and dedup through a side table, so each of its
        distinct hashes enters once.  Occurrences mode counts every emission,
        reads without a barcode included, and its groups fold into the
        normal stream.  Flushes run between steps.

        ``local_shard`` (multi-process runs only): ``fqb`` is this process's
        barcode-disjoint shard of the lane, not the whole lane."""
        if self.cfg.n_shards > 1:
            return self._count_sharded(fqb, local_shard)
        if local_shard:
            raise ValueError("local_shard input requires --shards over a "
                             "multi-process group")
        cfg = self.cfg
        self._read_len = fqb.read_len
        slots = self._batch_shape()[1]
        cap = 1 << cfg.table_bits
        buf_cap = max(cap, max(1, cfg.flush_batches) * slots)
        if self.table is None:
            self.table = st.make_sorted_table(cap, buf_cap, self.device)
        self.table = st.grow_buf(self.table, buf_cap)
        occurrences = cfg.count_mode == "occurrences"
        keying = "hashes" if occurrences else "pairs"
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        group, gtab = None, None
        spans, steps = self._lane_steps(fqb)
        for grp, gid in self._step_groups(spans, not occurrences):
            if gtab is not None and gid != group:
                self._finish_group(gtab)
                group, gtab = None, None
            # hashes are 2k bits (hashspec.py)
            keys, wts, over = self._step(steps, grp, keying, 2 * cfg.spec.k)
            overflow += over
            if gid is None:
                self.table = st.append_pairs(self.table, keys, wts)
                continue
            if gtab is None:
                group = gid
                gtab = st.make_sorted_table(2 * slots, 2 * slots, self.device)
            gtab = st.append_pairs(gtab, keys, wts)
        if gtab is not None:
            self._finish_group(gtab)
        self.table = st.flush_grow(self.table)
        with timing.wait("count.overflow"):
            overflow = int(overflow)
        if overflow:
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
        if self.table is None and self._dt is not None:
            self._gather_table()
        if self.table is None:
            raise RuntimeError("no count table (read a lane first)")
        self.table = st.flush_grow(self.table)
        return self.table

    def _sharded_table(self) -> Optional[DS.ShardedSortedTable]:
        return self._dt if self.table is None else None

    def _gather_table(self) -> None:
        """The sharded count table as one table (commands that need the
        whole table: save, --writeCounts, errorFix); filter, incidence,
        histogram and info stay sharded.  A collective."""
        if self._ret_sh is not None and self._retained is None:
            self._gather_retained()   # before the sharded state goes
        h, c = DS.gather_sorted_compact(self._dt)
        self._dt = None
        self._ret_sh = None
        cap = 1 << self.cfg.table_bits
        self.table = st.merge_counts(
            st.make_sorted_table(cap, cap, self.device), h, c)

    @_span("histogram")
    def histogram(self, max_count: int = 256) -> np.ndarray:
        dt = self._sharded_table()
        if dt is not None:
            return DS.sorted_histogram(dt, max_count)
        t = self._flushed()
        hist = st.count_histogram(t.hashes, t.counts, max_count)
        with timing.wait("histogram"):
            return hist.cpu().numpy()

    def info(self, out=sys.stdout) -> None:
        hist = self.histogram()
        total = int(hist.sum())
        dt = self._sharded_table()
        # tables grow instead of spilling, so the overflow is always 0
        if dt is not None:
            out.write(f"table slots {dt.n_shards * dt.capacity()} "
                      f"kmers {dt.n_filled()} overflow 0\n")
        else:
            t = self.table
            out.write(f"table slots {t.capacity} kmers {t.n_filled} "
                      "overflow 0\n")
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
        saved = (self.table, self._dt, self._ret_sh, self._retained,
                 self._retained_counts, self.n_reads_counted,
                 self.cfg.count_mode)
        self.table = self._dt = None
        try:
            self.cfg.count_mode = "occurrences"
            self.count(fqb)
            return st.compact(self._flushed())
        finally:
            (self.table, self._dt, self._ret_sh, self._retained,
             self._retained_counts, self.n_reads_counted,
             self.cfg.count_mode) = saved

    @_span("error_fix")
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

    @_span("filter")
    def filter(self, min_count: int = 0, max_count: int = 0) -> None:
        """Keep the k-mers whose count lies in the band [lo, hi]."""
        lo = min_count or self.cfg.min_count
        hi = max_count or self.cfg.max_count
        if self._sharded_table() is not None:
            return self._filter_sharded(lo, hi)
        self.retained_hashes, self.retained_counts = st.compact(
            self._flushed(), lo, hi)
        self.timer.stage(f"filter [{lo},{hi}]: "
                         f"{self.retained_hashes.shape[0]} kmers kept")

    # -- incidence, clusters, split, report --------------------------------------

    @_span("incidence")
    def incidence(self, fqb: Fqb, local_shard: bool = False) -> None:
        """Second pass: the deduplicated k-mer x barcode incidence, in steps
        of up to ``flush_batches`` batches.  Lanes whose (barcode, hash)
        pair fits one int63 key buffer combined keys and rank them once at
        the end; others join each batch against the retained set.
        ``n_shards > 1``: the sharded pass (``_incidence_sharded``)."""
        if self._retained is None and self._ret_sh is None:
            self.filter()
        if self.cfg.n_shards > 1:
            return self._incidence_sharded(fqb, local_shard)
        if local_shard:
            raise ValueError("local_shard input requires --shards over a "
                             "multi-process group")
        cfg = self.cfg
        retained = self.retained_hashes
        n_kmers = retained.shape[0]
        n_codes = fqb.n_barcodes
        hb = combined_key_bits(cfg.spec.k, n_codes)
        if hb:   # keys (barcode << hb) | hash below n_codes << hb
            keying = dict(keying="combined", hb=hb,
                          key_bits=hb + max(n_codes - 1, 0).bit_length())
        else:    # keys barcode * n_kmers + rank below n_codes * n_kmers
            keying = dict(keying="join", retained=retained, n_kmers=n_kmers,
                          key_bits=(max(n_codes * n_kmers, 1) - 1)
                          .bit_length())
        self._read_len = fqb.read_len
        slots = self._batch_shape()[1]
        cap = 1 << cfg.table_bits
        pt = st.make_sorted_table(
            cap, max(cap, max(1, cfg.flush_batches) * slots), self.device)
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        spans, steps = self._lane_steps(fqb)
        # group tags do not matter here: the pair table dedups globally
        for grp, _ in self._step_groups(spans, False):
            keys, wts, over = self._step(steps, grp, **keying)
            overflow += over
            pt = st.append_pairs(pt, keys, wts)
        with timing.wait("incidence.overflow"):
            overflow = int(overflow)
        if overflow:
            self._raise_overflow("incidence")
        pt = st.flush_grow(pt)
        pairs = pt.hashes[:pt.n_filled]
        if hb:
            pairs = finalize_combined_pairs(pairs, retained, n_kmers, hb)
        self.inc = incidence_from_sorted_pairs(pairs, n_kmers, fqb.n_barcodes)
        self.timer.stage(f"incidence: {self.inc.n_pairs} pairs, "
                         f"{self.inc.n_codes} codes x {self.inc.n_kmers} kmers")

    @_span("cluster")
    def cluster(self, min_share: int = 0) -> None:
        """Per-barcode molecule clustering (``--codeClusters``) in the
        configured mode: uncapped friend (the sparse pipeline), capped
        friend or pair (``cluster/cooccur.py``)."""
        inc_any = self._inc_any()
        if inc_any is None:
            raise RuntimeError("cluster requires incidence (run incidence first)")
        cfg = self.cfg
        if ((cfg.n_shards > 1 or self._inc_sh is not None)
                and cfg.cluster_mode == "friend" and cfg.max_friends == 0):
            from .cluster.sparse_dist import cluster_codes_sparse_dist
            # blocked propagation where one label vector would be large
            blocks = cfg.cluster_label_blocks
            if not blocks and inc_any.n_pairs > (1 << 28):
                blocks = 1 << 26
            labels = cluster_codes_sparse_dist(
                inc_any, self._shard_group(),
                min_friend_share=cfg.min_friend_share,
                label_block_pairs=blocks, flat=True)
            self._set_labels(labels)
            if isinstance(labels, SI.ShardedLabels):
                self.timer.stage(f"cluster: {labels.n_molecules} molecules "
                                 f"over {inc_any.n_codes} codes")
                return
        else:
            labels = cooccur.cluster_codes(
                self.inc, min_share=min_share or cfg.min_share,
                mode=cfg.cluster_mode, min_friend_share=cfg.min_friend_share,
                max_friends=cfg.max_friends)
            self._set_labels(labels)
        inc = self.inc
        n_cl = 0
        if inc.n_pairs:
            # labels are canonical per-code ranks: molecules = sum(max + 1)
            per_code = torch.zeros(inc.n_codes, dtype=torch.int64,
                                   device=self.device)
            per_code.scatter_reduce_(0, inc.code_of_pair(), labels + 1, "amax")
            with timing.wait("cluster.molecules"):
                n_cl = int(per_code.sum())
        self.timer.stage(f"cluster: {n_cl} molecules over {inc.n_codes} codes")

    @_span("split")
    def split(self) -> None:
        """Remap (code, cluster) -> new molecule codes (``--clusterSplit``):
        new ids are the dense ranks of the distinct (code, label) pairs in
        ascending order, the oracle's ``split_codes`` numbering."""
        if not self._has_labels():
            raise RuntimeError("split requires clusters")
        if self._labels_sh is not None and self._inc_sh is not None:
            return self._split_sharded()
        inc = self.inc
        if inc.n_pairs == 0:
            self.split_inc = incidence_from_sorted_pairs(
                inc.code_kmers, inc.n_kmers, 0)
            self.split_origin = torch.zeros((0, 2), dtype=torch.int64,
                                            device=self.device)
            self.timer.stage("split: 0 molecule codes")
            return
        with timing.wait("split"):
            K = int(self.cluster_labels.max()) + 1
        comb = inc.code_of_pair() * K + self.cluster_labels
        timing.add("sorted_keys", 2 * comb.shape[0])   # unique, then sort
        with timing.wait("split"):
            uniq, new_code, sizes = torch.unique(
                comb, sorted=True, return_inverse=True, return_counts=True)
        self._mol_cache = (uniq, sizes, K)
        pair2 = torch.sort(new_code * inc.n_kmers + inc.code_kmers).values
        self.split_inc = incidence_from_sorted_pairs(
            pair2, inc.n_kmers, uniq.shape[0])
        self.split_origin = torch.stack([uniq // K, uniq % K], dim=1)
        self.timer.stage(f"split: {uniq.shape[0]} molecule codes")

    @_span("report")
    def report(self, out=sys.stdout) -> None:
        """Cluster report (``--clusterReport``): one line per code with its
        k-mer count, cluster count and cluster sizes."""
        if not self._has_labels():
            raise RuntimeError("report requires clusters")
        if self._labels_sh is not None and self._inc_sh is not None:
            return self._report_sharded(out)
        inc = self.inc
        if self._mol_cache is None:  # split computes it on the way
            K = 1
            if inc.n_pairs:
                with timing.wait("report"):
                    K = int(self.cluster_labels.max()) + 1
            uniq, sizes = device_unique(
                inc.code_of_pair() * K + self.cluster_labels,
                return_counts=True)
            self._mol_cache = (uniq, sizes, K)
        uniq, sizes, K = self._mol_cache
        with timing.wait("report", 2 if uniq.numel() else 0):
            n_clusters = torch.bincount(uniq // K, minlength=inc.n_codes)
        write_report(out, torch.diff(inc.code_offsets), n_clusters, sizes)
        self.timer.stage(f"report: {inc.n_codes} codes")

    def write_counts(self, out=sys.stdout) -> None:
        """Dump the full (hash, count) table as text, hash-ascending."""
        h, c = st.compact(self._flushed())
        write_rows(out, [("x", h), b"\t", ("d", c), b"\n"], h.shape[0],
                   h.device)

    def write_clusters(self, out=sys.stdout) -> None:
        """Dump cluster assignments: one line per (code, kmer hash, cluster)."""
        if self.cluster_labels is None:
            raise RuntimeError("write_clusters requires clusters")
        inc = self.inc
        write_rows(out, [("d", inc.code_of_pair()), b"\t",
                         ("x", self.retained_hashes[inc.code_kmers]), b"\t",
                         ("d", self.cluster_labels), b"\n"], inc.n_pairs,
                   inc.device)

    # -- sharded paths (n_shards > 1) ------------------------------------------

    def _shard_group(self) -> ShardGroup:
        """The group of ``n_shards`` shards over this run's processes."""
        n = self.cfg.n_shards
        if self._inc_sh is not None:
            n = self._inc_sh.n
        if self._group is None or self._group.n_shards != n:
            self._group = ShardGroup.of_process(n, self.device)
        return self._group

    def _shard_schedule(self, fqb: Fqb, local_shard: bool):
        """This process's part of every global batch of a sharded pass:
        (lane, steps, per, spans).  ``lane`` is the device lane, ``per``
        the rows this process holds of each global batch, and ``spans``
        the batches as (a, a + m, group id): this process's m rows of the
        batch start at lane row a.  ``steps`` is the lane's ``LaneSteps``
        with one process (each step a CUDA graph replay on the card), None
        with several, whose steps run eagerly (every exchange crosses the
        host).  The whole lane loaded by every process: every process
        computes the same schedule and takes rows ``[rank * B / world,
        (rank + 1) * B / world)`` of each batch.  One process's local
        shard lane is cached with its steps, as ``_lane`` caches the whole
        lane, so the incidence pass replays the count pass's graphs' lane."""
        g = self._shard_group()
        per = self.cfg.batch_reads // g.world
        if local_shard:
            if g.world > 1:
                lane, spans = self._local_shard_lane(fqb, per)
                return lane, None, per, spans
            c = self._shard_lane_cache
            if c is None or c[0] is not fqb or c[1] != per:
                lane, spans = self._local_shard_lane(fqb, per)
                c = self._shard_lane_cache = (fqb, per, lane, spans,
                                              self._global_n_barcodes,
                                              LaneSteps(lane))
            self._global_n_barcodes = c[4]
            return c[2], c[5], per, c[3]
        lane, spans = self._lane(fqb)
        out = []
        for a, b, gid in spans:
            lo = a + g.rank * per
            out.append((lo, lo + min(max(b - lo, 0), per), gid))
        return lane, (self._lane_cache[4] if g.world == 1 else None), per, \
            out

    def _local_shard_lane(self, fqb: Fqb, per: int):
        """Per-process input shards: each process holds its own
        barcode-disjoint reads (checked by gathering every barcode key) and
        fills its row block of every global batch.  Global barcode ids are
        ranks in the global key set, the ids one process would give the
        whole lane; the returned lane carries them.  In barcodes mode an
        oversized barcode's batches become global batches of their own
        process (the others send empty rows, spans (0, 0)), so its side
        table sees only its reads.  Sets ``_global_n_barcodes``.  (The JAX
        feed also ORs per-batch flags over the processes to pick one jit
        variant; the CUDA kernel takes short reads and N bases, so the port
        has no per-batch variant to agree on.)"""
        g = self._shard_group()
        rls = g.host_allgather(np.array([fqb.read_len], np.int64)).reshape(-1)
        if not (rls == rls[0]).all():
            raise ValueError("shard files disagree on read_len: "
                             f"{rls.tolist()}")
        counts = g.host_allgather(
            np.array([fqb.n_barcodes], np.int64)).reshape(-1)
        self._global_n_barcodes = int(counts.sum())
        maxb = max(int(counts.max()), 1)
        pad_keys = np.zeros(maxb, np.int64)
        pad_keys[:fqb.n_barcodes] = fqb.barcode_keys.astype(np.int64)
        all_keys = g.host_allgather(pad_keys)
        sorted_keys = np.sort(np.concatenate(
            [all_keys[p, :counts[p]] for p in range(len(counts))]))
        if (sorted_keys[1:] == sorted_keys[:-1]).any():
            raise ValueError(
                "per-process fqb shards share barcodes; shard files must be "
                "barcode-disjoint (split the lane by barcode)")
        with timing.wait("lane.shard"):
            l2g = torch.from_numpy(np.searchsorted(
                sorted_keys, fqb.barcode_keys.astype(np.int64))
                .astype(np.int64) if fqb.n_barcodes
                else np.zeros(1, np.int64)).to(self.device)
        (packed, lengths, bcs, nmask), spans = self._lane(fqb, per)
        lane = (packed, lengths, torch.where(bcs >= 0, l2g[bcs.clamp(min=0)],
                                             -1), nmask)
        if self.cfg.count_mode == "barcodes":
            normal = [(a, e) for a, e, gid in spans if gid is None]
            groups, last = [], None
            for a, e, gid in spans:
                if gid is None:
                    continue
                if groups and last == gid:
                    groups[-1].append((a, e))
                else:
                    groups.append([(a, e)])
                last = gid
        else:
            normal, groups = [(a, e) for a, e, _ in spans], []
        shapes = g.host_allgather(np.array([len(normal), len(groups)],
                                           np.int64)).reshape(-1, 2)
        sizes = np.zeros(max(int(shapes[:, 1].max(initial=0)), 1), np.int64)
        sizes[:len(groups)] = [len(x) for x in groups]
        all_sizes = g.host_allgather(sizes)
        # the global schedule, the same on every process: every normal
        # batch, then each process's groups in (process, group) order
        out = [(*(normal[b] if b < len(normal) else (0, 0)), None)
               for b in range(int(shapes[:, 0].max(initial=0)))]
        gctr = 0
        for p in range(g.world):
            for gi in range(int(shapes[p, 1])):
                gctr += 1
                out += [(*(groups[gi][j] if p == g.rank else (0, 0)), gctr)
                        for j in range(int(all_sizes[p, gi]))]
        return lane, out

    def _shard_step(self, run, cs: DS.SortedCountStep, t, grp,
                    src=None) -> None:
        """One stacked sharded step of ``cs`` over the spans ``grp`` (at most
        ``flush_batches``) of the schedule ``run`` into the table ``t``.  S
        is ``len(grp)`` rounded up to a power of two, as in ``_step``; pad
        batches are empty.  ``src``: the retained band a pair step keys
        with (its graph is captured again when it changes)."""
        lane, steps, per, _ = run
        S = 1 << (len(grp) - 1).bit_length()
        om = np.zeros((2, S), np.int64)
        om[:, :len(grp)] = np.array([(a, b - a) for a, b in grp]).T
        self.timer.add("dispatches")
        if steps is not None:
            out = steps.sharded(cs, om, per, self._read_len, src)
        else:
            out = sharded_step(cs, lane, torch.from_numpy(om).to(self.device),
                               per, self._read_len)
        cs.append(t, out, S, len(grp))

    def _count_step(self, g: ShardGroup, count_mode: str, **retained):
        """The sharded step of this lane; ``retained`` (``n_codes`` and the
        band) makes it the incidence pair step."""
        cfg = self.cfg
        return DS.SortedCountStep(
            cfg.spec, g, mode=cfg.mode, modulus=cfg.modulus,
            syncmer_s=cfg.syncmer_s, lane_capacity=cfg.lane_capacity,
            count_mode=count_mode,
            compact_to=self._compact_rows(self._read_len - cfg.spec.k + 1),
            emission_cap_factor=cfg.emission_cap_factor, **retained)

    def _sharded_table_for(self, g: ShardGroup, step, routing="range"):
        """A sharded table whose buffers hold ``flush_batches`` batches."""
        cfg = self.cfg
        cap = max((1 << cfg.table_bits) // cfg.n_shards, 1 << 14)
        width = step.recv_width(cfg.batch_reads, self._read_len)
        buf = 1 << max(int(2 * max(1, cfg.flush_batches) * width - 1)
                       .bit_length(), 14)
        return DS.ShardedSortedTable(g, cap, buf, spec=cfg.spec,
                                     routing=routing)

    def _lane_retry(self, what: str, once, *args) -> None:
        """Run a sharded pass; on lane overflow run it again with doubled
        lanes (the counts of a pass with drops cannot be patched), at most
        three times.  The grown ``lane_capacity`` stays for later passes."""
        cfg = self.cfg
        self.timer.add("shard.sweep_retries", 0)   # held from here on
        for attempt in range(4):
            try:
                return once(*args)
            except DS.LaneOverflowError as e:
                if attempt == 3:
                    raise
                cfg.lane_capacity = 2 * (cfg.lane_capacity or e.auto_cap
                                         or 8192)
                self.timer.add("shard.sweep_retries")
                self.timer.stage(f"{what}[sharded]: lane overflow ({e}); "
                                 "retrying with --laneCapacity "
                                 f"{cfg.lane_capacity}")

    def _check_sharded_batch(self, g: ShardGroup) -> None:
        bsz = self.cfg.batch_reads
        if bsz % self.cfg.n_shards:
            raise ValueError("batch_reads must be divisible by n_shards")
        if bsz % g.world:
            raise ValueError("batch_reads must be divisible by the process "
                             "count")

    def _count_sharded(self, fqb: Fqb, local_shard: bool) -> None:
        self._lane_retry("count", self._count_sharded_once, fqb, local_shard)

    def _count_sharded_once(self, fqb: Fqb, local_shard: bool) -> None:
        """Sharded count pass, the port of the JAX engine's sharded count
        loops (``scan_spans`` on one process, ``scan_stacked`` through
        ``_stacked_dispatcher`` across processes): steps of up to
        ``flush_batches`` global batches, each one sketch launch over this
        process's rows of its batches, whose emissions route batch by batch
        to their hash-range owner shards and reduce there
        (``SortedCountStep.stacked``).  With one process every step is one
        CUDA graph replay on the card; over several processes the steps run
        eagerly.  In barcodes mode an oversized barcode's batches go one per
        step into a side table (occurrences, same splitters) whose distinct
        keys merge in shard-locally at the group's end.  The table stays
        sharded for filter and incidence."""
        cfg = self.cfg
        g = self._shard_group()
        self._check_sharded_batch(g)
        self._read_len = fqb.read_len
        run = self._shard_schedule(fqb, local_shard)
        step = self._count_step(g, cfg.count_mode)
        dt = self._sharded_table_for(g, step)
        side = side_step = None
        cur = None
        for grp, gid in self._step_groups(run[3],
                                          cfg.count_mode == "barcodes"):
            if gid is not None:
                if side_step is None:
                    side_step = self._count_step(g, "occurrences")
                if gid != cur and side is not None:
                    dt = DS.merge_group(dt, side)
                    side = None
                cur = gid
                if side is None:
                    side = self._sharded_table_for(g, side_step)
                self._shard_step(run, side_step, side, grp)
                continue
            if side is not None:
                dt = DS.merge_group(dt, side)
                side, cur = None, None
            self._shard_step(run, step, dt, grp)
        if side is not None:
            dt = DS.merge_group(dt, side)
        dt = step.finish(dt)
        drops = DS.host_sum(g, dt.drops)
        if drops:
            raise DS.LaneOverflowError(
                f"sharded count dropped {drops} emissions (lane/cap "
                "overflow)", auto_cap=cfg.lane_capacity or step.auto_lane_cap(
                    cfg.batch_reads, fqb.read_len))
        if DS.host_sum(g, dt.sketch_over):
            self._raise_overflow("count")
        n_new = int((fqb.lengths > 0).sum())
        if local_shard:
            n_new = int(g.host_allgather(np.array([n_new], np.int64)).sum())
        self.n_reads_counted += n_new
        self.table, self._dt = None, dt
        self._ret_sh = None
        tag = (f" over {g.world} {g.backend} processes" if g.world > 1
               else "")
        self.timer.stage(f"count[sharded x{cfg.n_shards}{tag}]: "
                         f"{self.n_reads_counted} reads, {dt.n_filled()} "
                         "kmers")

    def _filter_sharded(self, lo: int, hi: int) -> None:
        """The band, shard-side: the retained set stays sharded (ascending
        ranges, so local rank + shard offset is the canonical k-mer id)."""
        dt = self._dt.flush()
        g = dt.group
        rows, crows = [], []
        for i in range(g.n_local):
            h, c = dt.local_compact(i)
            keep = (c >= lo) & (c <= hi)
            with timing.wait("filter.sharded", 2):
                rows.append(h[keep])
                crows.append(c[keep])
        per = g.gather_counts([r.shape[0] for r in rows])
        off = np.concatenate([[0], np.cumsum(per)])[:-1].astype(np.int64)
        self._retained = self._retained_counts = None
        self._ret_sh = (rows, crows, off, int(per.sum()))
        self.timer.stage(f"filter[sharded x{dt.n_shards}] [{lo},{hi}]: "
                         f"{int(per.sum())} kmers kept")

    def _incidence_sharded(self, fqb: Fqb, local_shard: bool) -> None:
        self._lane_retry("incidence", self._incidence_sharded_once, fqb,
                         local_shard)

    def _incidence_sharded_once(self, fqb: Fqb, local_shard: bool) -> None:
        """Sharded incidence, in the count pass's stacked steps: (hash,
        barcode) emissions route to the hash's range owner, which holds
        only its slice of the retained set and keys the pair with the
        canonical k-mer rank; pair keys route by low bits to dedup owners;
        one more all_to_all lays the pair set out as code-range forward-CSR
        slices (``build_sharded_incidence``)."""
        cfg = self.cfg
        g = self._shard_group()
        self._check_sharded_batch(g)
        self._read_len = fqb.read_len
        run = self._shard_schedule(fqb, local_shard)
        n_codes = self._global_n_barcodes if local_shard else fqb.n_barcodes
        if self._ret_sh is not None:
            rows, _, off, n_kmers = src = self._ret_sh
            step = self._count_step(g, "occurrences", n_codes=n_codes,
                                    pair_retained_sharded=(rows, off, n_kmers))
        else:
            src = self.retained_hashes
            n_kmers = int(src.shape[0])
            step = self._count_step(g, "occurrences", n_codes=n_codes,
                                    pair_retained=src)
        dt = self._sharded_table_for(g, step, routing="low")
        # group tags do not matter here: the pair table dedups globally
        for grp, _ in self._step_groups(run[3], False):
            self._shard_step(run, step, dt, grp, src)
        dt = step.finish(dt)
        drops = DS.host_sum(g, dt.drops)
        if drops:
            raise DS.LaneOverflowError(
                f"sharded incidence dropped {drops} pair keys (lane/cap "
                "overflow)", auto_cap=cfg.lane_capacity or step.auto_lane_cap(
                    cfg.batch_reads, fqb.read_len))
        if DS.host_sum(g, dt.sketch_over):
            self._raise_overflow("incidence")
        self._set_inc_sh(SI.build_sharded_incidence(dt, n_kmers, n_codes))
        self.timer.stage(f"incidence[sharded x{cfg.n_shards}]: "
                         f"{self._inc_sh.n_pairs} pairs, {n_codes} codes x "
                         f"{n_kmers} kmers")

    def _split_sharded(self) -> None:
        """``--clusterSplit`` over sharded labels: the split pair set stays
        sharded; only the (molecules, 2) origin table is gathered."""
        codes_m, labels_m, _ = self._labels_sh.molecule_stats(self._inc_sh)
        split_sh = SI.split_sharded(self._inc_sh, self._labels_sh)
        self.split_inc = None
        self._split_inc_sh = split_sh
        with timing.wait("split"):
            self.split_origin = torch.from_numpy(
                np.stack([codes_m, labels_m], axis=1)).to(self.device)
        self.timer.stage(f"split: {len(codes_m)} molecule codes")

    def _report_sharded(self, out) -> None:
        """The report from per-molecule statistics reduced shard-side:
        O(codes + molecules) reach the host, never the pairs."""
        inc_sh = self._inc_sh
        codes_m, _, sizes = self._labels_sh.molecule_stats(inc_sh)
        cols = (np.diff(inc_sh.code_offsets),
                np.bincount(codes_m, minlength=inc_sh.n_codes), sizes)
        with timing.wait("report", 3):
            cols = [torch.from_numpy(np.asarray(a, np.int64)).to(self.device)
                    for a in cols]
        write_report(out, *cols)
        self.timer.stage(f"report: {inc_sh.n_codes} codes")

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
        self._dt = None   # replace means replace: no sharded state survives
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

