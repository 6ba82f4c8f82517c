"""The port's Engine count half (count, histogram, info, filter) against the
JAX Engine on the same lanes.  Comparisons are exact: the (hash, count)
table, the retained band and the report text.  The one number allowed to
differ is the one after ``table slots``: each package grows its table on its
own schedule (the JAX one follows its TPU flush plan)."""

import io
import re

import numpy as np
import pytest
import torch

from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.fastq import ReadBatch as JReadBatch
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu.table import sorted_table as JST
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.io.fastq import ReadBatch
from hash10x_tpu_torch.table import sorted_table as st

torch.set_num_threads(2)


def _sim_lane():
    sim = simulate(SimConfig(genome_len=150_000, n_barcodes=90,
                             molecules_per_barcode=2, molecule_len=5000,
                             reads_per_molecule=24, read_len=110,
                             error_rate=0.004, seed=4))
    return sim.reads


def _ragged_n_lane(rng):
    """Reads with N bases, short reads and invalid barcodes (length 0)."""
    n, L = 1500, 100
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lengths = rng.integers(15, L + 1, size=n).astype(np.int32)
    lengths[rng.random(n) < 0.02] = 0
    keys = rng.integers(0, 40, size=n).astype(np.uint32) * 7919
    return codes, lengths, keys


def _run_both(jfqb, fqb, k, w, batch_reads, mode="minimizer"):
    jeng = JEngine(JConfig(spec=JHashSpec(k=k, w=w, seed=17), mode=mode,
                           batch_reads=batch_reads, table_bits=12), log=None)
    jeng.count(jfqb)
    eng = Engine(EngineConfig(spec=HashSpec(k=k, w=w, seed=17), mode=mode,
                              batch_reads=batch_reads, table_bits=12),
                 "cpu", log=None)
    eng.count(fqb)
    return jeng, eng


def _texts(e):
    info, hist = io.StringIO(), io.StringIO()
    e.info(info)
    e.write_histogram(hist)
    return info.getvalue(), hist.getvalue()


def _check_count_half(jeng, eng, lo, hi):
    jh, jc = JST.compact(jeng._flushed())
    th, tc = (x.numpy() for x in st.compact(eng._flushed()))
    assert len(jh) > 1000
    assert (th == jh.astype(np.int64)).all() and (tc == jc).all()
    assert eng.n_reads_counted == jeng.n_reads_counted
    (ji, jd), (ti, td) = _texts(jeng), _texts(eng)
    assert td == jd
    slots = re.compile(r"^table slots \d+ ")
    assert slots.sub("table slots N ", ti) == slots.sub("table slots N ", ji)
    assert ti.startswith("table slots ") and "\n" in ti
    jeng.filter(lo, hi)
    eng.filter(lo, hi)
    assert (eng.retained_hashes.numpy()
            == jeng.retained_hashes.astype(np.int64)).all()
    assert (eng.retained_counts.numpy() == jeng.retained_counts).all()


@pytest.mark.parametrize("k,w,batch_reads,mode", [
    (21, 11, 4096, "minimizer"), (17, 7, 512, "minimizer"),
    (21, 11, 1024, "kmer")])
def test_count_filter_match_jax_on_sim_lane(k, w, batch_reads, mode):
    reads = _sim_lane()
    jfqb = JFB.from_read_batch(reads)
    fqb = FB.from_read_batch(ReadBatch(reads.codes, reads.lengths,
                                       reads.barcodes))
    jeng, eng = _run_both(jfqb, fqb, k, w, batch_reads, mode)
    _check_count_half(jeng, eng, 2, 6)


def test_count_with_n_bases_short_reads_and_bad_barcodes(rng):
    codes, lengths, keys = _ragged_n_lane(rng)
    jfqb = JFB.from_read_batch(JReadBatch(codes, lengths, keys))
    fqb = FB.from_read_batch(ReadBatch(codes, lengths, keys))
    assert fqb.nmask is not None and (fqb.barcode_ids < 0).any()
    jeng, eng = _run_both(jfqb, fqb, 13, 5, 256)
    _check_count_half(jeng, eng, 2, 0)


def test_not_ported_paths_raise(rng):
    """Every sketch and count mode of the JAX engine is ported: unknown
    modes raise ValueError, and the paths that raised NotImplementedError
    before (modimizer, occurrences mode, a barcode with more reads than a
    batch) now run."""
    spec = HashSpec(k=21, w=11, seed=17)
    for cfg in (EngineConfig(spec=spec, mode="bogus"),
                EngineConfig(spec=spec, count_mode="bogus")):
        with pytest.raises(ValueError, match="unknown"):
            Engine(cfg, "cpu", log=None)
    codes = rng.integers(0, 4, size=(40, 60)).astype(np.uint8)
    fqb = FB.from_read_batch(ReadBatch(codes, np.full(40, 60, np.int32),
                                       np.full(40, 5, np.uint32)))
    for cfg in (EngineConfig(spec=spec, batch_reads=16),
                EngineConfig(spec=spec, batch_reads=16, mode="modimizer"),
                EngineConfig(spec=spec, batch_reads=16,
                             count_mode="occurrences")):
        eng = Engine(cfg, "cpu", log=None)
        eng.count(fqb)
        assert eng.n_reads_counted == 40 and eng.table.n_filled > 0


def test_count_twice_accumulates_like_jax():
    reads = _sim_lane()
    jfqb = JFB.from_read_batch(reads)
    fqb = FB.from_read_batch(ReadBatch(reads.codes, reads.lengths,
                                       reads.barcodes))
    jeng, eng = _run_both(jfqb, fqb, 21, 11, 4096)
    jeng.count(jfqb)
    eng.count(fqb)
    _check_count_half(jeng, eng, 3, 0)
