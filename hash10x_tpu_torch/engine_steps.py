"""Multi-batch device steps of the count and incidence passes: the port of
the JAX engine's ``_fused_count_scan`` and ``_fused_pair_scan``
(``hash10x_tpu/engine.py:922-1011``, ``:1742-1841``).

A step covers S batches of ``bsz`` reads of the device lane
(``Engine._lane``), given as S (offset, m) pairs.  It gathers the S row
windows (rows past m get length 0 and barcode -1, so a pad batch emits only
``INT64_MAX``), unpacks them, makes one ``kernels.minimizer.sketch`` call on
the stacked (S * bsz, L) codes, keys the emissions and reduces each batch
on its own to ``slots`` entries (``sorted_table.dedup_*_segmented``).  It
returns ``(keys (S * slots,), weights (S * slots,) int32, overflow)``:
batch j's entries in slots ``[j * slots, (j + 1) * slots)``, and overflow a
device scalar that counts the emissions past the kernel's compaction width
and the distinct keys past each batch's slots.  The caller appends the real
batches' entries to a table's buffer; the host reads nothing back.

Keyings (``StepSpec.keying``):

* ``"hashes"``: the count pass in occurrences mode, the emitted hashes;
* ``"pairs"``: the count pass in barcodes mode, (hash, barcode) pairs, each
  hash weighted by its distinct barcodes in the batch;
* ``"combined"``: the incidence pass, ``(barcode << hb) | hash``;
* ``"join"``: the incidence pass, ``barcode * n_kmers + rank`` of the hash
  in the retained set (``table.incidence.pair_keys``).

The sharded passes send the same kind of step (:func:`sharded_step`, the
JAX package's ``scan_spans`` / ``scan_stacked``): S (offset, m) windows of
this process's rows of S global batches, one sketch launch, then
``dist.sharded_sorted.SortedCountStep.stacked`` routes and reduces every
(local shard, batch) row on its own.

On CUDA each step shape (a ``StepSpec``, or ``SortedCountStep.graph_key``
for a sharded step of one process) is captured once into a CUDA graph,
after one warm-up call on a side stream, and each step is one replay of it:
the host copies the (offset, m) pairs into the graph's static input and
replays.  The graph holds the lane's and, for ``"join"`` and the sharded
pair step, the retained set's addresses, so ``LaneSteps`` lives with the
lane and captures such a step again when the retained set changes.  Its
outputs are static tensors that the next replay overwrites; the caller
copies them first, in stream order.  A capture or a replay that fails
raises: a step never falls back to eager work on the card.  On the CPU the
same step runs eagerly, and so does a sharded step of several processes,
whose exchanges cross the host.

A capture is the host-clock span ``step.capture`` and adds 1 to the counter
``graph_captures`` of the current timer (``utils/timing.py``).  The counters
its captured work adds (the dedup sorts' ``sorted_keys``, a sharded step's
``shard.route_slots``) are tallied apart at capture, and each replay adds
them, as ``minimizer.count_replay`` adds the recorded launches; a counter
the work sums on the device (``shard.route_keys``) is a static output of
the graph, which each replay adds in stream order.  The warm-up call
records nothing.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import INT64_MAX
from .core.encode import unpack_2bit_torch
from .hashspec import HashSpec
from .kernels import minimizer
from .table import sorted_table as st
from .table.incidence import pair_keys
from .utils import timing

__all__ = ["StepSpec", "LaneSteps", "step", "sharded_step", "REPLAYS"]

REPLAYS = 0   # CUDA graph replays of steps


@dataclass(frozen=True)
class StepSpec:
    """Everything a step computes from besides its lane and (offset, m)
    pairs; the key of its CUDA graph."""
    S: int              # batches per step
    bsz: int            # reads per batch
    read_len: int
    spec: HashSpec
    mode: str
    modulus: int
    syncmer_s: int
    C: int              # the kernel's compaction width (0 = dense rows)
    slots: int          # entries per batch
    keying: str         # hashes | pairs | combined | join
    key_bits: int       # real keys lie below 2**key_bits
    hb: int = 0         # "combined": the barcode's shift
    n_kmers: int = 0    # "join": the retained set's size


def _gather(lane, om: torch.Tensor, bsz: int, read_len: int):
    """The S row windows ``om[0] + [0, bsz)`` of the lane, rows past
    ``om[1]`` emptied: (codes (S * bsz, L) uint8, lengths int32, barcodes
    int64)."""
    packed, lengths, bcs, nmask = lane
    r = torch.arange(bsz, device=om.device)
    valid = (r < om[1, :, None]).reshape(-1)
    rows = (om[0, :, None] + r).reshape(-1).clamp(max=lengths.shape[0] - 1)
    ln = torch.where(valid, lengths.index_select(0, rows), 0)
    bc = torch.where(valid, bcs.index_select(0, rows), -1)
    nm = None
    if nmask is not None:
        nm = torch.where(valid[:, None], nmask.index_select(0, rows), 0)
    return (unpack_2bit_torch(packed.index_select(0, rows), read_len, nm),
            ln, bc)


def step(ss: StepSpec, lane, om: torch.Tensor, retained=None):
    """One step over the (2, S) int64 offsets and m's ``om`` on the lane's
    device: ``(keys, weights, overflow)`` (see the module docstring)."""
    codes, ln, bc = _gather(lane, om, ss.bsz, ss.read_len)
    h, _, emit, over = minimizer.sketch(
        ss.spec, codes, ln, mode=ss.mode, compact_to=ss.C, m=ss.modulus,
        syncmer_s=ss.syncmer_s)
    keyed = torch.where(emit, h, INT64_MAX)
    flat_bc = bc[:, None].expand(-1, h.shape[1])
    if ss.keying == "pairs":
        keys, wts, o = st.dedup_pairs_weighted_segmented(
            keyed.reshape(ss.S, -1), flat_bc.reshape(ss.S, -1), ss.slots,
            ss.key_bits)
    else:
        if ss.keying == "combined":
            ok = (keyed != INT64_MAX) & (flat_bc >= 0)
            keyed = torch.where(ok, (flat_bc << ss.hb) | keyed, INT64_MAX)
        elif ss.keying == "join":
            keyed = pair_keys(retained, keyed.reshape(-1),
                              flat_bc.reshape(-1), ss.n_kmers)
        keys, wts, o = st.dedup_weighted_segmented(
            keyed.reshape(ss.S, -1), ss.slots, ss.key_bits)
    return keys, wts, over.sum(dtype=torch.int64) + o.sum()


def sharded_step(cs, lane, om: torch.Tensor, bsz: int, read_len: int):
    """One stacked sharded step (the JAX package's ``scan_spans`` /
    ``scan_stacked``): the (2, S) row windows ``om`` of ``bsz`` rows each
    (this process's rows of S global batches) through
    ``SortedCountStep.stacked`` of ``cs``."""
    codes, ln, bc = _gather(lane, om, bsz, read_len)
    return cs.stacked(codes, ln, bc, om.shape[1])


# One capture stream and one graph memory pool per CUDA device, shared by
# every lane's graphs: the caching allocator reuses a block only on the
# stream and in the pool it came from, so graphs captured on streams or
# pools of their own would never reuse each other's intermediates, nor the
# memory of a dropped engine's graphs, and every new engine would reserve
# its graphs' memory anew.  Sharing is safe because every step replays on
# the current stream, one at a time, and a graph's intermediates are dead
# between its replays.  It has one cost: a later capture may place its
# outputs in an earlier graph's intermediates, so a graph's outputs are
# valid only until the next replay of any graph on the device, of any
# engine.  Every caller consumes them in stream order before that.
_CAPTURE = {}


def _capture_resources(dev):
    """(stream, pool) of the device, made on first use.  A one-op graph
    captured into the pool and kept with it holds the pool open: the
    allocator releases a pool whose graphs have all gone, and a capture
    into a released pool's handle fails."""
    if dev not in _CAPTURE:
        stream = torch.cuda.Stream(dev)
        pool = torch.cuda.graph_pool_handle()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            x = torch.zeros(1, device=dev)
            anchor = torch.cuda.CUDAGraph()
            anchor.capture_begin(pool=pool)
            x.add_(1)
            anchor.capture_end()
        torch.cuda.synchronize(dev)
        _CAPTURE[dev] = (stream, pool, anchor, x)
    return _CAPTURE[dev][:2]


class LaneSteps:
    """The steps of one device lane: on CUDA a captured graph per step
    shape (replayed one at a time, on the current stream), on the CPU the
    eager step.  A replay's outputs are valid only until the next replay of
    any graph on the device, of this or any other engine (the graphs share
    one memory pool): consume them in stream order first."""

    def __init__(self, lane):
        self.lane = lane
        self.device = lane[1].device
        self._graphs = {}

    def __call__(self, ss: StepSpec, om: np.ndarray, retained=None):
        """Run the step ``ss`` on the (2, S) int64 offsets and m's ``om``."""
        return self._run(ss, functools.partial(step, ss, self.lane,
                                               retained=retained), om,
                         retained)

    def sharded(self, cs, om: np.ndarray, bsz: int, read_len: int,
                src=None):
        """Run :func:`sharded_step` of ``cs``, a ``SortedCountStep`` of a
        one-process group, on the (2, S) int64 offsets and m's ``om``.
        ``src`` is the retained band a pair step keys with: its graph holds
        the band's rows, and a new ``src`` captures the step again."""
        if cs.group.world != 1:
            raise ValueError("a multi-process step exchanges through the "
                             "host: run sharded_step eagerly")
        return self._run(cs.graph_key(om.shape[1], bsz, read_len),
                         functools.partial(sharded_step, cs, self.lane,
                                           bsz=bsz, read_len=read_len), om,
                         src)

    def _run(self, key, fn, om: np.ndarray, src):
        """``fn(om)``: eagerly on the CPU; on CUDA the replay of its graph,
        captured on first use and again for a new ``src`` (then the graphs
        of the old retained band go: no later step keys with it).  ``fn``
        holds no reference to this object, so an engine that drops its
        lane frees the graphs' memory at once."""
        if self.device.type != "cuda":
            return fn(torch.from_numpy(om).to(self.device))
        g = self._graphs.get(key)
        if g is None or g.src is not src:
            if src is not None:
                self._graphs = {k: h for k, h in self._graphs.items()
                                if h.src is None or h.src is src}
            g = self._graphs[key] = _StepGraph(fn, om.shape[1], self.device,
                                               src)
        return g.replay(om)


class _StepGraph:
    """One step ``fn(om)`` captured into a CUDA graph: a static (2, S)
    input and the static outputs of its one capture.  It keeps ``fn``, and
    so the tensors the graph reads, alive."""

    def __init__(self, fn, S: int, dev, src):
        timing.add("graph_captures")
        with timing.span("step.capture"):
            self._capture(fn, S, dev, src)

    def _capture(self, fn, S: int, dev, src):
        minimizer.build()   # load the kernel library outside the capture
        self.fn, self.src = fn, src
        self.om = torch.zeros((2, S), dtype=torch.int64, device=dev)
        cur = torch.cuda.current_stream(dev)
        side, pool = _capture_resources(dev)
        side.wait_stream(cur)
        tally = timing.StageTimer(None)   # the counters of one replay
        with torch.cuda.stream(side):
            # warm-up (all batches empty): lazy initialisation and the
            # kernel module's load happen here, not under capture
            with timing.recording(None):
                fn(self.om)
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            n0 = minimizer.CAPTURED
            self.graph.capture_begin(pool=pool)
            try:
                with timing.recording(tally):
                    self.out = fn(self.om)
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)
        self.launches = minimizer.CAPTURED - n0
        self.counters = tally.counters
        # device scalars its captured work counts (``timing.add_device``):
        # static outputs that each replay overwrites
        self.device_counters = tally.device_counters

    def replay(self, om: np.ndarray):
        """Replay on the current stream with the (2, S) input ``om``.  The
        static outputs it returns hold until the next replay of any graph
        on the device (one shared pool, see ``_CAPTURE``)."""
        global REPLAYS
        self.om.copy_(torch.from_numpy(om), non_blocking=True)
        self.graph.replay()
        REPLAYS += 1
        minimizer.count_replay(self.launches)
        for name, n in self.counters.items():
            timing.add(name, n)
        for name, x in self.device_counters.items():
            timing.add_device(name, x)
        return self.out
