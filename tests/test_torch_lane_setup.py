"""The lane set-up (``Engine._lane``): the barcode ids sorted on the device
and the file-order lane put in barcode order there give, bit for bit, the
JAX engine's barcode-sorted lane arrays and batch spans
(``hash10x_tpu.engine.Engine._spans``: a stable numpy argsort, numpy
gathers and a walk over the sorted ids), for shuffled barcodes with reads
that have none, an oversized barcode, Ns, a lane already in barcode order,
a lane with no barcode at all, and the batch size of a sharded call; and
the staging ring's chunks (``_row_chunks``) cover an array in whole rows,
on the ring's slots in turn."""

import numpy as np
import pytest
import torch

from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu_torch import engine as E
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.io.fqb import Fqb

BATCH = 128


def _jax_lane(fqb: Fqb, bsz: int):
    """The JAX engine's lane arrays in barcode order and batch spans."""
    jfqb = JFB.Fqb(packed=fqb.packed, lengths=fqb.lengths,
                   barcode_ids=fqb.barcode_ids,
                   barcode_keys=fqb.barcode_keys, read_len=fqb.read_len,
                   nmask=fqb.nmask)
    *lane, spans = JEngine(JConfig(batch_reads=BATCH), log=None)._spans(
        jfqb, bsz)
    return lane, spans


def _fqb(kind: str, seed: int = 0) -> Fqb:
    rng = np.random.default_rng(seed)
    n_codes = 40
    per = rng.integers(1, 30, n_codes)
    if kind == "oversized":
        per[7] = 3 * BATCH + 17
    ids = np.repeat(np.arange(n_codes, dtype=np.int32), per)
    ids[rng.random(len(ids)) < (1.0 if kind == "no_barcode" else 0.1)] = -1
    if kind != "sorted":
        ids = ids[rng.permutation(len(ids))]
    n = len(ids)
    nmask = None
    if kind == "ns":
        nmask = np.zeros((n, 5), np.uint32)
        rows = rng.random(n) < 0.05
        nmask[rows] = rng.integers(0, 1 << 32, (rows.sum(), 5), np.uint32)
    return Fqb(packed=rng.integers(0, 1 << 32, (n, 10), np.uint32),
               lengths=rng.integers(60, 151, n, np.int32), barcode_ids=ids,
               barcode_keys=np.arange(n_codes, dtype=np.uint32), read_len=150,
               nmask=nmask)


@pytest.mark.parametrize("bsz", [0, BATCH // 2], ids=["batch", "per"])
@pytest.mark.parametrize("kind", ["shuffled", "oversized", "ns", "sorted",
                                  "no_barcode"])
def test_lane_equals_the_jax_lane(kind, bsz):
    fqb = _fqb(kind)
    eng = Engine(EngineConfig(batch_reads=BATCH), "cpu", log=None)
    with eng.timer.span("count"):
        lane, spans = eng._lane(fqb, bsz)
    want, want_spans = _jax_lane(fqb, bsz or BATCH)
    assert spans == want_spans
    assert (kind == "oversized") == any(g is not None for _, _, g in spans)
    # words and N masks as int32, lengths int32, barcode ids widened
    for got, ref, dtype in zip(lane, want, (torch.int32, torch.int32,
                                            torch.int64, torch.int32)):
        if ref is None:
            assert got is None
            continue
        assert got.dtype == dtype and got.is_contiguous()
        assert got.shape == ref.shape
        assert np.array_equal(got.numpy(),
                              ref.view(np.int32) if ref.dtype == np.uint32
                              else ref.astype(np.int64) if dtype == torch.int64
                              else ref)
    n = len(fqb)
    stats = eng.stats
    assert stats["sorted_keys"] == n
    assert stats["lane_bytes"] == 52 * n + (0 if fqb.nmask is None
                                            else fqb.nmask.nbytes)
    assert stats["lane_staged_bytes"] == 0      # no staging on the CPU


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("bsz", [1, 7, 40])
def test_spans_equal_the_jax_spans(seed, bsz):
    """Batch spans from the reads per barcode against the JAX engine's walk
    over the sorted ids, on lanes of runs near the batch size, empty
    barcodes and reads without one (none, some, all)."""
    rng = np.random.default_rng(seed)
    per = rng.integers(0, 2 * bsz + 2, rng.integers(0, 30))
    ids = np.repeat(np.arange(len(per), dtype=np.int32), per)
    no_bc = (0.0, 0.2, 1.0)[seed % 3]
    ids[rng.random(len(ids)) < no_bc] = -1
    ids = np.concatenate([ids, np.full(rng.integers(0, 3 * bsz), -1,
                                       np.int32)])
    ids = ids[rng.permutation(len(ids))]
    fqb = Fqb(packed=np.zeros((len(ids), 1), np.uint32),
              lengths=np.zeros(len(ids), np.int32), barcode_ids=ids,
              barcode_keys=np.arange(len(per), dtype=np.uint32), read_len=16)
    eng = Engine(EngineConfig(batch_reads=bsz), "cpu", log=None)
    assert eng._lane(fqb)[1] == _jax_lane(fqb, bsz)[1]


@pytest.mark.parametrize("n,row,stage", [
    (0, 40, 40), (1, 40, 40), (5, 4, 4), (37, 4, 4), (37, 4, 12),
    (37, 4, 40), (37, 12, 12), (37, 12, 40), (37, 20, 1 << 24),
    (1000, 40, 120), (1000, 40, 200), (1000, 40, 1 << 24)])
def test_row_chunks_cover_the_array_in_whole_rows(n, row, stage,
                                                  monkeypatch):
    """The chunks ``_staged`` sends: back to back from row 0 to n, each a
    whole number of rows and at most a buffer, the ring's slots in turn."""
    monkeypatch.setattr(E, "STAGE_BYTES", stage)
    chunks = list(E._row_chunks(n, row))
    edges = [0] + [hi for _, hi, _ in chunks]
    assert [lo for lo, _, _ in chunks] == edges[:-1] and edges[-1] == n
    assert all(0 < (hi - lo) * row <= stage for lo, hi, _ in chunks)
    assert all(hi - lo == stage // row for lo, hi, _ in chunks[:-1])
    assert [s for _, _, s in chunks] == [k % E.STAGE_RING
                                         for k in range(len(chunks))]
