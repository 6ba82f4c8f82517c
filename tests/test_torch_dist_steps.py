"""The sharded multi-batch dispatch (``SortedCountStep.stacked``,
``engine_steps.sharded_step``: the port of the JAX package's
``scan_spans`` / ``scan_stacked``) against the JAX package and against its
own steps of one batch.

* The port's sharded engine at ``flush_batches`` 1, 3, 16 and 2 and 8
  shards, in both count modes, gives the JAX sharded engine's gathered
  count table at the same settings, and its retained set and incidence
  pairs and their labels (the JAX engine at ``flush_batches`` 16, the
  labels by the JAX package's clustering), on a lane with N bases, short
  and empty reads, reads without a barcode and one barcode larger than a
  batch.  ``stats["dispatches"]`` is the step count.  The JAX engine runs
  on the 8-device virtual CPU mesh (``tests/conftest.py``).
* One stacked step over S batches (pad batches included) equals S stacked
  steps of one batch each: the same flushed table shard by shard and the
  same drops per shard and sketch overflow, with
  ``--laneCapacity 8`` (drops in every batch) and auto lanes, for the count
  step in both modes, the incidence pair step, and with keys too wide to
  fold the row index in (the dedup's extra sort, k = 31).
* Two processes over gloo exchange per-batch lanes ``(n_local, n, S,
  cap)`` trimmed to the widest fill without mixing batches.

Every comparison is exact (tolerance: none; keys, counts, offsets and
labels are integers)."""

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hash10x_tpu.cluster import sparse as JSP
from hash10x_tpu.dist import sharded_sorted as JDS
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.fastq import ReadBatch as JReadBatch
from hash10x_tpu_torch import engine_steps as ES
from hash10x_tpu_torch.dist import sharded_sorted as DS
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.io.fastq import ReadBatch
from hash10x_tpu_torch.table import sorted_table as st

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BATCH = 256
W, SEED = 11, 17
FIELDS = ("code_offsets", "code_kmers")


@functools.lru_cache(maxsize=None)
def _lanes():
    """(JAX fqb, port fqb) of one lane: 2,400 reads of 100 bp from a 40 kb
    genome, 45 barcodes of ~40 reads and one of 600 (larger than a
    256-read batch), 0.5% N bases, 4% short reads, 1% empty, 2% without a
    barcode."""
    rng = np.random.default_rng(12)
    L, n_small, n_big = 100, 1800, 600
    genome = rng.integers(0, 4, size=40_000).astype(np.uint8)
    n = n_small + n_big
    starts = rng.integers(0, len(genome) - L, size=n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    codes[rng.random(codes.shape) < 0.005] = 4
    lengths = np.full(n, L, np.int32)
    short = rng.random(n) < 0.04
    lengths[short] = rng.integers(15, L, size=int(short.sum()))
    lengths[rng.random(n) < 0.01] = 0
    keys = np.concatenate([np.full(n_big, 7, np.uint32),
                           rng.integers(100, 145, size=n_small)
                           .astype(np.uint32) * 13])
    fqb = FB.from_read_batch(ReadBatch(codes, lengths, keys))
    jfqb = JFB.from_read_batch(JReadBatch(codes, lengths, keys))
    no_bc = rng.random(n) < 0.02
    fqb.barcode_ids[no_bc] = -1
    jfqb.barcode_ids[no_bc] = -1
    return jfqb, fqb


def _kw(n, flush_batches, count_mode):
    return dict(table_bits=12, batch_reads=BATCH, count_mode=count_mode,
                min_count=2, max_count=60, min_friend_share=4, n_shards=n,
                flush_batches=flush_batches)


@functools.lru_cache(maxsize=None)
def _jax_engine(n, count_mode):
    """One JAX sharded engine per mesh and count mode: ``reset()`` keeps
    its compiled steps for the next ``flush_batches``."""
    return JEngine(JConfig(spec=JHashSpec(k=21, w=W, seed=SEED),
                           **_kw(n, 16, count_mode)), log=None)


@functools.lru_cache(maxsize=None)
def _jax(n, flush_batches, count_mode):
    """The JAX sharded engine's gathered count table at ``flush_batches``;
    at 16 also its retained set, incidence pairs and their labels (by the
    JAX package's clustering, which its sharded clustering equals)."""
    jfqb, _ = _lanes()
    je = _jax_engine(n, count_mode)
    je.reset()
    je.cfg.flush_batches = flush_batches
    je.count(jfqb)
    h, c = JDS.gather_sorted_compact(je._dt)
    out = {"counts": (h.astype(np.int64).tolist(), c.tolist())}
    if flush_batches == 16:
        je.filter()
        je.incidence(jfqb)
        inc = je.inc
        out.update(
            retained=je.retained_hashes.astype(np.int64).tolist(),
            inc={f: np.asarray(getattr(inc, f)).tolist() for f in FIELDS},
            labels=np.asarray(JSP.cluster_codes_sparse(
                inc, min_friend_share=4, flat=True)).tolist())
    return out


def _n_steps(eng, fqb, split_groups):
    return len(list(eng._step_groups(eng._lane(fqb)[1], split_groups)))


@pytest.mark.parametrize("flush_batches", [1, 3, 16])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("count_mode", ["barcodes", "occurrences"])
def test_sharded_passes_match_jax(count_mode, n, flush_batches):
    _, fqb = _lanes()
    eng = Engine(EngineConfig(spec=HashSpec(k=21, w=W, seed=SEED),
                              **_kw(n, flush_batches, count_mode)), "cpu",
                 log=None)
    eng.count(fqb)
    h, c = DS.gather_sorted_compact(eng._dt)
    assert (h.tolist(), c.tolist()) == _jax(n, flush_batches,
                                            count_mode)["counts"]
    n_count = _n_steps(eng, fqb, count_mode == "barcodes")
    assert eng.stats["dispatches"] == n_count
    assert (n_count < len(eng._lane(fqb)[1])) == (flush_batches > 1)
    eng.filter()
    eng.incidence(fqb)
    assert eng.stats["dispatches"] == n_count + _n_steps(eng, fqb, False)
    eng.cluster()
    want = _jax(n, 16, count_mode)
    assert eng.retained_hashes.tolist() == want["retained"]
    assert eng.inc.n_pairs > 1000
    for f in FIELDS:
        assert getattr(eng.inc, f).tolist() == want["inc"][f], f
    assert eng.cluster_labels.tolist() == want["labels"]


@pytest.mark.parametrize("count_mode", ["barcodes", "occurrences"])
def test_one_process_local_shard_lane_is_cached(count_mode):
    """``--readFQBShard`` at one process gives the whole lane's tables, and
    the incidence pass steps over the count pass's cached lane and steps
    (on the card: the same graphs)."""
    _, fqb = _lanes()
    engines = [Engine(EngineConfig(spec=HashSpec(k=21, w=W, seed=SEED),
                                   **_kw(2, 16, count_mode)), "cpu", log=None)
               for _ in range(2)]
    whole, local = engines
    whole.count(fqb)
    local.count(fqb, local_shard=True)
    cached = local._shard_lane_cache
    assert cached[5].lane is cached[2]
    for a, b in zip(DS.gather_sorted_compact(whole._dt),
                    DS.gather_sorted_compact(local._dt)):
        assert a.tolist() == b.tolist()
    for e in engines:
        e.filter()
    whole.incidence(fqb)
    local.incidence(fqb, local_shard=True)
    assert local._shard_lane_cache is cached
    assert local.retained_hashes.tolist() == whole.retained_hashes.tolist()
    for f in FIELDS:
        assert getattr(local.inc, f).tolist() == getattr(whole.inc, f).tolist()


# -- one stacked step against S steps of one batch ----------------------------

def _step_case(n, kind, k, lane_capacity):
    """An engine over the lane (k, n shards, the lane capacity), its device
    lane and spans, and the sharded step of ``kind`` (occurrences |
    barcodes | pair) with a table for it."""
    _, fqb = _lanes()
    spec = HashSpec(k=k, w=W, seed=SEED)
    eng = Engine(EngineConfig(spec=spec, lane_capacity=lane_capacity,
                              **_kw(n, 16, "barcodes")), "cpu", log=None)
    eng._read_len = fqb.read_len
    lane, spans = eng._lane(fqb)
    g = eng._shard_group()
    if kind == "pair":
        single = Engine(EngineConfig(spec=spec, **_kw(1, 16, "barcodes")),
                        "cpu", log=None)
        single.count(fqb)
        single.filter()
        cs = eng._count_step(g, "occurrences", n_codes=fqb.n_barcodes,
                             pair_retained=single.retained_hashes)
    else:
        cs = eng._count_step(g, kind)
    return eng, lane, spans, cs


@pytest.mark.parametrize("n,kind,k,lane_capacity", [
    (2, "occurrences", 21, 8), (8, "barcodes", 21, 8), (8, "pair", 21, 8),
    (2, "barcodes", 21, 0), (4, "pair", 21, 0), (2, "barcodes", 31, 8),
    (8, "pair", 31, 0)])
def test_stacked_step_equals_per_batch_calls(n, kind, k, lane_capacity):
    eng, lane, spans, cs = _step_case(n, kind, k, lane_capacity)
    read_len = eng._read_len
    S, n_real = 8, 5
    # the oversized barcode's spans and the next two: one batch each
    om = np.zeros((2, S), np.int64)
    om[:, :n_real] = np.array([(a, b - a) for a, b, _ in spans[:n_real]]).T
    routing = "low" if kind == "pair" else "range"
    stacked = eng._sharded_table_for(cs.group, cs, routing)
    out = ES.sharded_step(cs, lane, torch.from_numpy(om), BATCH, read_len)
    keys = out[0]
    assert keys.shape == (n, S * cs.slots_recv(BATCH, read_len))
    cs.append(stacked, out, S, n_real)
    calls = eng._sharded_table_for(cs.group, cs, routing)
    for j in range(n_real):
        cs.append(calls, ES.sharded_step(cs, lane, torch.from_numpy(
            om[:, j:j + 1]), BATCH, read_len), 1, 1)
    stacked.flush()
    calls.flush()
    assert stacked.drops.tolist() == calls.drops.tolist()
    assert (int(stacked.drops.sum()) > 0) == (lane_capacity == 8)
    assert int(stacked.sketch_over) == int(calls.sketch_over)
    for i in range(n):
        got, want = st.compact(stacked.rows[i]), st.compact(calls.rows[i])
        assert got[0].tolist() == want[0].tolist()
        assert got[1].tolist() == want[1].tolist()
    assert sum(r.n_filled for r in stacked.rows) > 0
    # k = 31 hashes (62 bits) leave no room for the row index: extra sort
    folds = cs.key_bits + (n * S - 1).bit_length() <= 62
    assert folds == (k == 21 or kind == "pair")


def test_stacked_overflow_is_counted_per_shard():
    """Distinct keys past a batch's slots count as drops of the shard that
    received them, as a step of that one batch counts them."""
    eng, lane, spans, cs = _step_case(2, "occurrences", 21, 0)
    cs.slots_recv = lambda batch_reads, read_len: 64
    om = np.array([[spans[3][0], spans[4][0]],
                   [spans[3][1] - spans[3][0], spans[4][1] - spans[4][0]]])
    stacked = eng._sharded_table_for(cs.group, cs)
    cs.append(stacked, ES.sharded_step(cs, lane, torch.from_numpy(om), BATCH,
                                       eng._read_len), 2, 2)
    calls = eng._sharded_table_for(cs.group, cs)
    for j in range(2):
        cs.append(calls, ES.sharded_step(cs, lane, torch.from_numpy(
            om[:, j:j + 1]), BATCH, eng._read_len), 1, 1)
    assert (stacked.drops > 0).all()
    assert stacked.drops.tolist() == calls.drops.tolist()


# -- per-batch lanes between two processes ---------------------------------------

_TWO_PROCESS_A2A = r"""
import sys
import torch
import torch.distributed as dist
from hash10x_tpu_torch.dist.group import ShardGroup

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
n, S, cap = 4, 3, 6
g = ShardGroup(n, "cpu", world=2, rank=rank)
fill = torch.randint(0, cap - 1, (n, n, S),
                     generator=torch.Generator().manual_seed(5))
fill[3, 0, 2] = cap - 2          # the widest lane: on process 1, batch 2
pos = torch.arange(cap)
src, dst, b = torch.meshgrid(torch.arange(n), torch.arange(n),
                             torch.arange(S), indexing="ij")
vals = (src * 1000 + dst * 100 + b * 10)[..., None] + pos
lanes = torch.where(pos < fill[..., None], vals, -1)   # (src, dst, S, cap)
mine = lanes[g.lo:g.hi]
assert g.lane_width(mine, -1) == cap - 2
recv = g.all_to_all(mine, -1)
assert torch.equal(recv, lanes[:, g.lo:g.hi].transpose(0, 1)), recv
assert torch.equal(g.all_to_all(mine[:, :, 1], -1),
                   lanes[:, g.lo:g.hi, 1].transpose(0, 1))
dist.destroy_process_group()
print("ok")
"""


def test_two_processes_exchange_per_batch_lanes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROCESS_A2A, str(r), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    res = []
    try:
        for p in procs:
            res.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0 and out.strip() == "ok", err[-2000:]
