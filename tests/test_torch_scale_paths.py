"""The code paths a real lane size takes (16M reads, 1M barcodes), held at
small size against the JAX package on the CPU.

* Combined keys too wide to fold the batch index: with k = 25 and 1,000
  barcodes the incidence key needs 60 bits, so ``_fold_rows`` returns None
  at S = 16 and every incidence step takes ``_by_row``'s extra sort, as
  k = 21 at 1,000,000 barcodes does (62 bits).  The lane's incidence,
  labels, report and dumps equal the JAX engine's.
* ``cluster_codes_sparse`` with co-occurrence chunks small enough to
  reduce several times and edge blocks small enough to scatter in many
  blocks, and ``cluster_codes_sparse_dist`` at 4 shards with many label
  blocks, equal the JAX ``cluster_codes_sparse`` on a dense-pileup
  ``synth_incidence``.
* The blocked lane generator: the same bytes at any chunk size and from
  the same seed, 16 reads per barcode sorted by barcode, each read inside
  its barcode's molecule.
* The sorted table's flush merges a sorted buffer into the table and
  grows the buffer with the table (O(log n) flushes; before, 122 flushes
  of a fixed 4.2M-entry buffer each sorted the whole table on the 16M-read
  lane): exact against a reference count, and the flush count bounded.
* The text writers (dumps and report, formatted as tensors: one f-string
  per line took 2.5-2.7 s for the 1M-line report on the 16M-read lane)
  equal the f-strings byte for byte.
* ``scale_ab.py`` imports no JAX and exits non-zero without a card.

Every comparison is exact (tolerance: none; all values are integers or
text)."""

import functools
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hash10x_tpu.cluster import sparse as JSP
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io.fqb import Fqb as JFqb
from hash10x_tpu.table.incidence import build_incidence as jbuild_incidence
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch import bench as B
from hash10x_tpu_torch.cluster import sparse as SP
from hash10x_tpu_torch.cluster import sparse_dist as SPD
from hash10x_tpu_torch.core.encode import unpack_2bit
from hash10x_tpu_torch.dist.group import ShardGroup
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.table import sorted_table as st
from hash10x_tpu_torch.table.incidence import (build_incidence,
                                               combined_key_bits)
from hash10x_tpu_torch.utils import text as T
from hash10x_tpu_torch.utils import timing

torch.set_num_threads(2)

FIELDS = ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
          "inv2fwd")
N_CODES, PER_CODE, GENOME = 1000, 4, 600_000
BATCH = 256


def _incidence_key_bits(k, n_codes):
    """The engine's combined incidence key width (``Engine.incidence``)."""
    hb = combined_key_bits(k, n_codes)
    assert hb
    return hb + max(n_codes - 1, 0).bit_length()


def test_fold_rows_gives_up_at_one_million_barcodes():
    bits = _incidence_key_bits(21, 1_000_000)
    assert bits == 62
    flat = torch.zeros(16 * 8, dtype=torch.int64)
    assert st._fold_rows(flat, 16, bits) is None
    # 65,536 barcodes (58 bits) still fold at S = 16
    assert st._fold_rows(flat, 16, _incidence_key_bits(21, 1 << 16)) \
        is not None


# -- the k = 25 lane: combined keys that do not fold -------------------------

@functools.lru_cache(maxsize=None)
def _k25_lane():
    fqb = B.make_barcodes_lane_blocked(N_CODES * PER_CODE, N_CODES, GENOME,
                                       seed=3)
    jfqb = JFqb(packed=fqb.packed, lengths=fqb.lengths,
                barcode_ids=fqb.barcode_ids, barcode_keys=fqb.barcode_keys,
                read_len=fqb.read_len)
    return jfqb, fqb


def _kw():
    return dict(table_bits=12, batch_reads=BATCH, flush_batches=16,
                min_count=2, max_count=64, min_friend_share=4)


def _texts(eng):
    out = []
    for write in (eng.report, eng.write_clusters, eng.write_counts):
        buf = io.StringIO()
        write(buf)
        out.append(buf.getvalue())
    return out


@functools.lru_cache(maxsize=None)
def _jax_k25():
    jfqb, _ = _k25_lane()
    jeng = JEngine(JConfig(spec=JHashSpec(k=25, w=11, seed=17), **_kw()),
                   log=None)
    jeng.count(jfqb)
    jeng.filter()
    jeng.incidence(jfqb)
    inc = {f: np.asarray(getattr(jeng.inc, f)).tolist() for f in FIELDS}
    jeng.cluster()
    labels = np.asarray(jeng.cluster_labels).tolist()
    jeng.split()
    return inc, labels, _texts(jeng)


def test_k25_lane_incidence_takes_the_extra_sort_and_matches_jax(
        monkeypatch):
    _, fqb = _k25_lane()
    bits = _incidence_key_bits(25, fqb.n_barcodes)
    assert bits == 60
    assert st._fold_rows(torch.zeros(16, dtype=torch.int64), 16, bits) \
        is None
    eng = Engine(EngineConfig(spec=HashSpec(k=25, w=11, seed=17), **_kw()),
                 "cpu", log=None)
    eng.count(fqb)
    eng.filter()
    sorts = []
    real = st._by_row

    def spy(order, N):
        sorts.append(N)
        return real(order, N)
    monkeypatch.setattr(st, "_by_row", spy)
    eng.incidence(fqb)
    monkeypatch.setattr(st, "_by_row", real)
    # 16 batches: one step of S = 16 a pass, and the incidence's took the
    # extra sort (the count pass's 50-bit pair keys fold)
    assert len(eng._spans(fqb)[1]) == 16
    assert eng.stats["dispatches"] == 2 and len(sorts) == 1
    inc, labels, texts = _jax_k25()
    for f in FIELDS:
        assert getattr(eng.inc, f).tolist() == inc[f], f
    assert eng.inc.n_pairs > 5_000
    eng.cluster()
    assert eng.cluster_labels.tolist() == labels
    assert max(labels) > 0
    eng.split()
    assert _texts(eng) == texts


# -- clustering in chunks and blocks ----------------------------------------

@functools.lru_cache(maxsize=None)
def _pileup():
    """A dense pileup (every span overlaps ~16 others): 2,000 codes x 30
    k-mers from two 64-wide spans over 16,000 k-mers, seed 5."""
    ks, cs = B.synth_incidence(2_000, 16_000, 30)
    jinc = jbuild_incidence(ks.astype(np.int32), cs.astype(np.int32),
                            n_kmers=16_000, n_codes=2_000)
    jlab = np.asarray(JSP.cluster_codes_sparse(jinc, min_friend_share=4,
                                               flat=True))
    return ks, cs, jlab.astype(np.int64).tolist()


@pytest.mark.parametrize("chunk,edge_block", [
    (SP._CHUNK, SP._EDGE_BLOCK), (1 << 12, SP._EDGE_BLOCK),
    (SP._CHUNK, 1 << 10), (1 << 12, 1 << 10)])
def test_cluster_sparse_in_chunks_and_blocks_matches_jax(chunk, edge_block):
    ks, cs, want = _pileup()
    inc = build_incidence(ks, cs, 16_000, 2_000, "cpu")
    with timing.recording(timing.StageTimer(None)) as timer:
        lab = SP.cluster_codes_sparse(inc, 4, chunk=chunk,
                                      edge_block=edge_block)
    assert lab.tolist() == want
    assert max(want) > 0
    stats = SP.STATS
    assert stats["friend_keys"] > 0 and stats["rounds"] >= 2
    if chunk < SP._CHUNK:
        assert timer.span_totals()["cluster.cooccur.reduce"]["n"] >= 4
    if edge_block < SP._EDGE_BLOCK:
        assert stats["edge_blocks"] >= 8


def test_cluster_sparse_dist_label_blocks_matches_jax():
    ks, cs, want = _pileup()
    inc = build_incidence(ks, cs, 16_000, 2_000, "cpu")
    lab = SPD.cluster_codes_sparse_dist(
        inc, ShardGroup.of_process(4, "cpu"), min_friend_share=4, flat=True,
        label_block_pairs=1 << 12)
    assert lab.tolist() == want
    assert SPD.STATS["label_blocks"] >= 8


# -- the blocked lane generator ----------------------------------------------

def test_blocked_generator_is_a_function_of_the_seed():
    a = B.make_barcodes_lane_blocked(3_200, 200, 1_000_000, chunk=1 << 17)
    b = B.make_barcodes_lane_blocked(3_200, 200, 1_000_000, chunk=333)
    c = B.make_barcodes_lane_blocked(3_200, 200, 1_000_000, seed=12)
    assert a.packed.tobytes() == b.packed.tobytes()
    assert a.packed.tobytes() != c.packed.tobytes()
    assert a.packed.shape == (3_200, 10) and a.packed.dtype == np.uint32
    assert (a.barcode_ids == np.repeat(np.arange(200), 16)).all()
    assert (np.diff(a.barcode_ids) >= 0).all()
    assert (a.lengths == 150).all() and a.n_barcodes == 200
    # each read is 150 bases of its barcode's 30 kb molecule
    genome = B.blocked_genome(1_000_000, 11)
    assert B.blocked_genome(1_000_000, 11).tobytes() == genome.tobytes()
    assert np.bincount(genome, minlength=4).min() > 240_000
    reads = unpack_2bit(a.packed, 150)
    pows = 4 ** np.arange(24, dtype=np.int64)
    prefixes = np.lib.stride_tricks.sliding_window_view(genome, 24) @ pows
    for bc in (0, 77, 199):
        starts = []
        for read in reads[a.barcode_ids == bc]:
            hits = [h for h in np.flatnonzero(prefixes == read[:24] @ pows)
                    if (genome[h:h + 150] == read).all()]
            assert hits
            starts.append(hits[0])
        assert max(starts) - min(starts) < B.MOLECULE


# -- the table's flush -------------------------------------------------------

def test_flush_merges_and_grows_the_buffer_with_the_table():
    """Weighted batches with repeats, pads and keys already in the table;
    the result equals a reference sum at every flush, the buffer grows to
    an eighth of the capacity as the table grows, and the flushes stay
    logarithmic in the appended volume."""
    rng = np.random.default_rng(4)
    t = st.make_sorted_table(1 << 8, 1 << 8, "cpu")
    ref = {}
    timer = timing.StageTimer(None)
    for step in range(400):
        k = rng.integers(0, 60_000, size=200).astype(np.int64)
        k[:50] = rng.integers(0, 300, size=50)   # hot keys
        w = rng.integers(1, 5, size=200).astype(np.int32)
        pad = rng.random(200) < 0.2
        k[pad], w[pad] = INT64_MAX, 0
        with timing.recording(timer):
            t = st.append_pairs(t, torch.from_numpy(k), torch.from_numpy(w))
        for a, b in zip(k[~pad].tolist(), w[~pad].tolist()):
            ref[a] = ref.get(a, 0) + b
    with timing.recording(timer):
        t = st.flush_grow(t)
    h, c = st.compact(t)
    keys = sorted(ref)
    assert h.tolist() == keys
    assert c.tolist() == [ref[x] for x in keys]
    assert (t.hashes[t.n_filled:] == INT64_MAX).all()
    assert t.capacity >= len(keys) / 0.6 and t.buf.shape[0] == \
        t.capacity // 8
    # 80,000 appended entries through a buffer of at most cap / 8: a fixed
    # 256-entry buffer would flush 313 times
    assert timer.counters["flushes"] <= 40


# -- the text writers --------------------------------------------------------

EDGE_VALUES = [0, 1, 9, 10, 15, 16, 99, 100, 255, 256, 10 ** 18 - 1,
               10 ** 18, 2 ** 62, INT64_MAX]


@pytest.mark.parametrize("rows", [T.ROWS, 7])
def test_write_rows_equals_fstrings(monkeypatch, rows):
    monkeypatch.setattr(T, "ROWS", rows)
    rng = np.random.default_rng(6)
    a = np.array(EDGE_VALUES + rng.integers(0, INT64_MAX, 300).tolist()
                 + rng.integers(0, 1000, 300).tolist(), np.int64)
    b = rng.permutation(a)
    out = io.StringIO()
    T.write_rows(out, [("d", torch.from_numpy(a)), b"\t",
                       ("x", torch.from_numpy(b)), b" -\n"], len(a), "cpu")
    assert out.getvalue() == "".join(f"{x}\t{y:x} -\n"
                                     for x, y in zip(a.tolist(), b.tolist()))
    out = io.StringIO()
    T.write_rows(out, [("x", torch.from_numpy(a[:0])), b"\n"], 0, "cpu")
    assert out.getvalue() == ""


@pytest.mark.parametrize("block", [1 << 18, 3])
def test_write_report_equals_fstrings(block):
    rng = np.random.default_rng(8)
    n = 40
    nk = rng.integers(0, 10 ** 6, n)
    ncl = rng.integers(0, 5, n)
    ncl[[0, 7, n - 1]] = 0
    sizes = rng.integers(1, 10 ** 4, int(ncl.sum()))
    out = io.StringIO()
    T.write_report(out, torch.from_numpy(nk), torch.from_numpy(ncl),
                   torch.from_numpy(sizes), codes_per_block=block)
    cs = np.concatenate([[0], np.cumsum(ncl)])
    want = "".join(
        f"code {c} nKmers {nk[c]} nClusters {ncl[c]} sizes "
        f"{','.join(map(str, sizes[cs[c]:cs[c + 1]].tolist()))}\n"
        for c in range(n))
    assert out.getvalue() == want


# -- scale_ab.py -------------------------------------------------------------

def test_scale_ab_needs_a_card_and_imports_no_jax():
    root = Path(B.__file__).resolve().parent.parent
    text = (root / "scale_ab.py").read_text()
    assert "import jax" not in text and "hash10x_tpu." not in \
        text.replace("hash10x_tpu_torch", "")
    r = subprocess.run([sys.executable, "scale_ab.py"], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and "no CUDA card" in r.stderr
    assert r.stdout == ""
