"""The sketch kernel's modimizer and syncmer modes and the engine paths they
run on, port against the JAX package.

* ``sketch_plain`` (the CUDA kernel's plain version) against the Pallas
  kernel in interpret mode (B=1024, as ``tests/test_kernel.py`` runs it),
  dense and compacted, and against ``seqhash_jnp`` on ragged lanes with N
  bases;
* the port ``Engine`` against the JAX ``Engine``: all four sketch modes in
  both count modes, oversized barcodes, reads without a barcode in
  occurrences mode, and ``error_fix`` drop-only and with rescue.

Every comparison is exact (tolerance: none; hashes, strands, emission
order, overflow counts and table text are integers)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hash10x_tpu.core import seqhash_jnp as J
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.fastq import ReadBatch as JReadBatch
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu.kernels import minimizer_pallas as MP
from hash10x_tpu.oracle import seqhash_ref
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.io.fastq import ReadBatch
from hash10x_tpu_torch.kernels import minimizer as MK

torch.set_num_threads(2)

MODE_KW = [("modimizer", {"m": 7}), ("modimizer", {"m": 11}),
           ("syncmer", {"syncmer_s": 5}), ("syncmer", {"syncmer_s": 11})]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plain(spec, codes, lengths, mode, kw, C=0):
    return [x.numpy() for x in MK.sketch_plain(
        HashSpec(k=spec.k, w=spec.w, seed=spec.seed), _t(codes), _t(lengths),
        mode=mode, compact_to=C, **kw)]


@pytest.mark.parametrize("mode,kw", MODE_KW)
def test_plain_modes_match_pallas_dense_and_compacted(rng, mode, kw):
    """B=1024 ragged reads (codes in [0,3], the Pallas kernel's domain):
    dense rows equal the Pallas kernel's; compacted rows hold the same
    emissions in the same order with the same exact overflow (a C below the
    mean forces it)."""
    spec = JHashSpec(k=21, w=11, seed=17)
    L = 120
    codes = rng.integers(0, 4, size=(1024, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=1024).astype(np.int32)
    lengths[:4] = L
    codes[0] = 1  # homopolymer
    h1, f1, e1 = (np.asarray(x) for x in MP.sketch(
        spec, jnp.asarray(codes), jnp.asarray(lengths), mode=mode, **kw))
    h2, f2, e2, ov = _plain(spec, codes, lengths, mode, kw)
    assert (e1 == e2).all() and e2.any() and not ov.any()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all()

    C = 8
    h1, f1, e1, ov1 = (np.asarray(x) for x in MP.sketch(
        spec, jnp.asarray(codes), jnp.asarray(lengths), mode=mode,
        compact_to=C, **kw))
    h2, f2, e2, ov2 = _plain(spec, codes, lengths, mode, kw, C)
    assert ov2.dtype == np.int32 and (ov1 == ov2).all() and ov2.max() > 0
    assert (e1 == e2).all()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all()
    assert (h2[~e2] == INT64_MAX).all()


@pytest.mark.parametrize("mode,kw", MODE_KW + [("modimizer", {"m": 1}),
                                               ("syncmer", {"syncmer_s": 20})])
def test_plain_modes_match_jnp_on_ragged_n_lanes(rng, mode, kw):
    """Ragged reads with N bases (which the Pallas kernel does not take),
    short reads and empty reads: the plain version equals seqhash_jnp
    dense, and its compacted rows are the dense emissions in order."""
    spec = JHashSpec(k=21, w=11, seed=17)
    B, L = 96, 90
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:3] = (L, 21, 0)
    h1, f1, e1 = (np.asarray(x) for x in J.sketch(
        spec, codes, lengths, mode=mode, m=kw.get("m", 0),
        syncmer_s=kw.get("syncmer_s", 0)))
    h2, f2, e2, _ = _plain(spec, codes, lengths, mode, kw)
    assert (e1 == e2).all() and e2.any()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all()
    hc, _, ec, ov = _plain(spec, codes, lengths, mode, kw, C=24)
    for r in range(B):
        got = hc[r][ec[r]].tolist()
        assert got == h2[r][e2[r]].tolist()[:24]
        assert ov[r] == max(int(e2[r].sum()) - 24, 0)


def test_syncmer_matches_oracle(rng):
    spec = JHashSpec(k=15, w=1, seed=17)
    codes = rng.integers(0, 4, size=(6, 70)).astype(np.uint8)
    lengths = np.full(6, 70, np.int32)
    h2, _, e2, _ = _plain(spec, codes, lengths, "syncmer", {"syncmer_s": 6})
    for r in range(6):
        exp = [p for p, _, _ in seqhash_ref.syncmers(spec, list(codes[r]), 6)]
        assert np.nonzero(e2[r])[0].tolist() == exp


# -- engine --------------------------------------------------------------------

def _sim_reads():
    return simulate(SimConfig(genome_len=60_000, n_barcodes=40,
                              molecules_per_barcode=2, molecule_len=4000,
                              reads_per_molecule=12, read_len=100,
                              error_rate=0.004, seed=6)).reads


def _lanes(codes, lengths, keys):
    return (JFB.from_read_batch(JReadBatch(codes, lengths, keys)),
            FB.from_read_batch(ReadBatch(codes, lengths, keys)))


def _engines(spec_kw, **cfg):
    j = JEngine(JConfig(spec=JHashSpec(**spec_kw), table_bits=12, **cfg),
                log=None)
    t = Engine(EngineConfig(spec=HashSpec(**spec_kw), table_bits=12, **cfg),
               "cpu", log=None)
    return j, t


def _counts_text(e):
    buf = io.StringIO()
    e.write_counts(buf)
    return buf.getvalue()


@pytest.mark.parametrize("count_mode", ["barcodes", "occurrences"])
@pytest.mark.parametrize("mode,extra", [
    ("kmer", {}), ("minimizer", {}), ("modimizer", {}),
    ("modimizer", {"modulus": 5}), ("syncmer", {"syncmer_s": 11})])
def test_engine_modes_match_jax(mode, extra, count_mode):
    reads = _sim_reads()
    jfqb, fqb = _lanes(reads.codes, reads.lengths, reads.barcodes)
    jeng, eng = _engines(dict(k=21, w=11, seed=17), mode=mode,
                         count_mode=count_mode, batch_reads=512, **extra)
    jeng.count(jfqb)
    eng.count(fqb)
    text = _counts_text(eng)
    assert text.count("\n") > 500
    assert text == _counts_text(jeng)
    assert eng.n_reads_counted == jeng.n_reads_counted == len(fqb)


def _oversized(rng, n_big=600, n_small=40, read_len=60):
    """tests/test_oversized.py's lane: one barcode with n_big reads (half of
    them one duplicated read) and three normal barcodes."""
    n = n_big + 3 * n_small
    codes = rng.integers(0, 4, size=(n, read_len)).astype(np.uint8)
    codes[1:n_big // 2] = codes[0]
    lengths = np.full(n, read_len, np.int32)
    keys = np.concatenate([np.zeros(n_big, np.uint32),
                           1 + (np.arange(3 * n_small, dtype=np.uint32) % 3)])
    return _lanes(codes, lengths, keys)


@pytest.mark.parametrize("count_mode", ["barcodes", "occurrences"])
def test_oversized_barcode_counts_match_jax(rng, count_mode):
    jfqb, fqb = _oversized(rng)
    jeng, eng = _engines(dict(k=13, w=5, seed=17), count_mode=count_mode,
                         batch_reads=128)
    jeng.count(jfqb)
    eng.count(fqb)
    assert _counts_text(eng) == _counts_text(jeng)
    # the same table as when the big barcode fits one batch
    _, big = _engines(dict(k=13, w=5, seed=17), count_mode=count_mode,
                      batch_reads=1024)
    big.count(fqb)
    assert _counts_text(big) == _counts_text(eng)
    assert eng.n_reads_counted == len(fqb)


def test_oversized_full_pipeline_matches_jax(rng):
    jfqb, fqb = _oversized(rng, n_big=200, n_small=30)
    outs = []
    for eng, lane in zip(_engines(dict(k=13, w=5, seed=17), batch_reads=64,
                                  min_count=1, max_count=10 ** 6),
                         (jfqb, fqb)):
        eng.count(lane)
        eng.filter()
        eng.incidence(lane)
        eng.cluster()
        eng.split()
        buf = io.StringIO()
        eng.report(buf)
        eng.write_clusters(buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") > 100


def test_reads_without_barcode_count_in_occurrences_mode(rng):
    codes = rng.integers(0, 4, size=(300, 80)).astype(np.uint8)
    lengths = np.full(300, 80, np.int32)
    keys = np.arange(300, dtype=np.uint32) // 10
    jfqb, fqb = _lanes(codes, lengths, keys)
    fqb.barcode_ids[:100] = -1
    jfqb.barcode_ids[:100] = -1
    texts = {}
    for cm in ("barcodes", "occurrences"):
        jeng, eng = _engines(dict(k=21, w=11, seed=17), count_mode=cm,
                             batch_reads=64)
        jeng.count(jfqb)
        eng.count(fqb)
        texts[cm] = _counts_text(eng)
        assert texts[cm] == _counts_text(jeng)
        assert eng.n_reads_counted == 300
    total = {cm: sum(int(l.split()[1]) for l in t.splitlines())
             for cm, t in texts.items()}
    assert total["occurrences"] > total["barcodes"] * 1.4


def _errorfix_lane(rng):
    """tests/test_errorfix.py's lane: X three times in barcode 0, Y once in
    barcode 1, Z once in each of barcodes 2..9."""
    L = 80
    gx, gy, gz = (rng.integers(0, 4, size=L).astype(np.uint8)
                  for _ in range(3))
    codes = np.stack([gx, gx, gx, gy] + [gz] * 8)
    keys = np.array([0, 0, 0, 1] + list(range(2, 10)), np.uint32)
    return _lanes(codes, np.full(len(codes), L, np.int32), keys), gx, gy


@pytest.mark.parametrize("min_reads,rescued", [(0, False), (2, True),
                                               (4, False)])
def test_error_fix_matches_jax(rng, min_reads, rescued):
    (jfqb, fqb), gx, gy = _errorfix_lane(rng)
    spec = JHashSpec(k=21, w=11, seed=17)
    sx = {h for _, h, _ in seqhash_ref.minimizers(spec, list(gx))}
    jeng, eng = _engines(dict(k=21, w=11, seed=17), batch_reads=16)
    for e, lane in ((jeng, jfqb), (eng, fqb)):
        e.count(lane)
        e.error_fix(1, fqb=lane, min_reads=min_reads)
    text = _counts_text(eng)
    assert text == _counts_text(jeng)
    keys = {int(l.split()[0], 16) for l in text.splitlines()}
    assert (sx <= keys) == rescued and bool(sx & keys) == rescued
    assert eng.n_reads_counted == jeng.n_reads_counted == 12
    assert eng.cfg.count_mode == "barcodes"


def test_error_fix_rescue_needs_reads_and_barcodes_mode(rng):
    (_, fqb), _, _ = _errorfix_lane(rng)
    eng = Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                              batch_reads=16), "cpu", log=None)
    eng.count(fqb)
    with pytest.raises(RuntimeError, match="no reads are loaded"):
        eng.error_fix(1, min_reads=2)
    occ = Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                              count_mode="occurrences"), "cpu", log=None)
    occ.count(fqb)
    with pytest.raises(RuntimeError, match="count_mode='occurrences'"):
        occ.error_fix(1, fqb=fqb, min_reads=2)
