"""The port's sharded engine (``Engine`` with ``n_shards``) against the JAX
package's ``Engine(n_shards=n)`` on the 8-device virtual CPU mesh, on one
small lane with N bases, reads shorter than k + w and one barcode with more
reads than a batch: info text, histogram, retained set, incidence (every
field, ``inv2fwd`` included), labels, split and report are equal, and the
shard-resident state is equal shard by shard.  Lane overflow retries with
doubled lanes exactly as the JAX engine does.  Every comparison is exact
(tolerance: none)."""

import io
import re

import numpy as np
import pytest
import torch

from hash10x_tpu.core.encode import pack_2bit as jpack
from hash10x_tpu.dist import sharded_sorted as JDS
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.fqb import Fqb as JFqb
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.dist import sharded_sorted as DS
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB

torch.set_num_threads(2)

SLOTS = re.compile(r"^table slots \d+ ", re.M)
K, W, SEED = 21, 7, 17
U64MAX = np.uint64(2**64 - 1)


def lane_arrays():
    """A sim lane with N bases, short reads (0 < P < w) and the barcode of
    read 0 widened to 700 reads (> the 512-read batch)."""
    sim = simulate(SimConfig(genome_len=40_000, n_barcodes=24,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=30, read_len=100, seed=5))
    rb = sim.reads
    codes, lens = rb.codes.copy(), rb.lengths.copy()
    codes[::7, 3] = 4                       # N bases
    lens[3::11] = K + W - 3                 # P = w - 2
    bcs = rb.barcodes.copy()
    bcs[:700] = bcs[0]                      # one oversized barcode
    return type(rb)(codes=codes, lengths=lens, barcodes=bcs)


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist_engine") / "lane.fqb")
    JFB.save_fqb(path, JFB.from_read_batch(lane_arrays()))
    return path


def drive(eng, fqb):
    eng.count(fqb)
    info = io.StringIO()
    eng.info(info)
    hist = np.asarray(eng.histogram(64))
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    eng.split()
    rep = io.StringIO()
    eng.report(rep)
    return SLOTS.sub("table slots N ", info.getvalue()), hist, rep.getvalue()


def jax_engine(n):
    return JEngine(JConfig(spec=JHashSpec(k=K, w=W, seed=SEED),
                           table_bits=14, batch_reads=512, min_count=2,
                           max_count=40, min_friend_share=4, n_shards=n),
                   log=None)


def port_engine(n, **kw):
    return Engine(EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                               table_bits=14, batch_reads=512, min_count=2,
                               max_count=40, min_friend_share=4, n_shards=n,
                               **kw), "cpu", log=None)


@pytest.fixture(scope="module", params=[2, 8])
def both(request, lane):
    n = request.param
    je = jax_engine(n)
    jout = drive(je, JFB.load_fqb(lane))
    pe = port_engine(n)
    pout = drive(pe, FB.load_fqb(lane))
    return n, je, jout, pe, pout


def test_text_and_histogram_equal(both):
    n, je, jout, pe, pout = both
    assert pout[0] == jout[0] and "distinct kmers" in pout[0]
    assert (pout[1] == jout[1]).all()
    assert pout[2] == jout[2] and "code 12 nKmers" in pout[2]
    assert pout[2].count("nClusters 0") < 3


def test_sharded_state_equal_shard_by_shard(both):
    n, je, jout, pe, pout = both
    rows, crows, off, total = convert.retained_sharded_to_numpy(
        pe._ret_sh, pe._shard_group())
    jrows, jcrows, joff, jtotal = je._ret_sh
    jrows, jcrows = np.asarray(jrows), np.asarray(jcrows)
    assert total == jtotal and list(off) == list(joff)
    for s in range(n):
        jr = jrows[s][jrows[s] != U64MAX]
        assert rows[s][rows[s] != U64MAX].tolist() == jr.tolist()
        assert crows[s][:len(jr)].tolist() == jcrows[s][:len(jr)].tolist()
    jrows_t, jcrows_t, joff_t, jtotal_t = convert.retained_sharded_from_numpy(
        je._ret_sh, pe._shard_group())
    prows, pcrows, _, _ = pe._ret_sh
    assert jtotal_t == total and list(joff_t) == list(off)
    assert [r.tolist() for r in jrows_t] == [r.tolist() for r in prows]
    assert [c.tolist() for c in jcrows_t] == [c.tolist() for c in pcrows]
    keys, counts = convert.sharded_incidence_to_numpy(pe._inc_sh)
    jkeys = np.asarray(je._inc_sh.keys)
    assert counts.tolist() == je._inc_sh.pair_counts.tolist()
    for s in range(n):
        assert keys[s][keys[s] != U64MAX].tolist() == \
            jkeys[s][jkeys[s] != U64MAX].tolist()
    assert pe._inc_sh.code_offsets.tolist() == \
        je._inc_sh.code_offsets.tolist()


def test_whole_views_equal(both):
    n, je, jout, pe, pout = both
    assert pe.retained_hashes.tolist() == \
        je.retained_hashes.astype(np.int64).tolist()
    assert pe.retained_counts.tolist() == je.retained_counts.tolist()
    pi, ji = pe.inc, je.inc
    assert pi.n_pairs == ji.n_pairs > 0
    for f in ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
              "inv2fwd"):
        want = np.asarray(getattr(ji, f)).tolist()
        assert getattr(pi, f).tolist() == want, f
    assert pe.cluster_labels.tolist() == je.cluster_labels.tolist()
    assert pe.split_origin.tolist() == je.split_origin.tolist()
    for f in ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes"):
        assert getattr(pe.split_inc, f).tolist() == \
            np.asarray(getattr(je.split_inc, f)).tolist(), f


def test_sharded_equals_single_gpu_path(lane, both):
    """The port's sharded run equals its own single-device run."""
    n, je, jout, pe, pout = both
    single = port_engine(1)
    sout = drive(single, FB.load_fqb(lane))
    assert sout[0] == pout[0] and sout[2] == pout[2]
    assert (sout[1] == pout[1]).all()
    assert single.cluster_labels.tolist() == pe.cluster_labels.tolist()


def test_lane_overflow_retry_equals_jax():
    """Mirror of test_dist.py::test_lane_overflow_auto_retry_completes: a
    poly-A lane sends every emission to one shard; both engines drop the
    same number of emissions, retry with the same doubled lanes, keep the
    grown capacity and end with the plain table."""
    n, L = 2048, 120
    kw = dict(packed=jpack(np.zeros((n, L), np.uint8)),
              lengths=np.full(n, L, np.int32),
              barcode_ids=np.zeros(n, np.int32),
              barcode_keys=np.zeros(1, np.uint32), read_len=L)
    jstages, pstages = [], []
    je = JEngine(JConfig(spec=JHashSpec(k=21, w=1, seed=17),
                         count_mode="occurrences", table_bits=14,
                         batch_reads=2048, flush_batches=2, n_shards=8),
                 log=None)
    je.timer.stage = jstages.append
    je.count(JFqb(**kw))
    pe = Engine(EngineConfig(spec=HashSpec(k=21, w=1, seed=17),
                             count_mode="occurrences", table_bits=14,
                             batch_reads=2048, n_shards=8), "cpu", log=None)
    pe.timer.stage = pstages.append
    pe.count(FB.Fqb(**kw))
    retries = [s for s in pstages if "lane overflow" in s]
    assert len(retries) == 2 and retries == jstages[:2]
    assert pe.cfg.lane_capacity == je.cfg.lane_capacity > 0
    jh, jc = JDS.gather_sorted_compact(je._dt)
    h, c = DS.gather_sorted_compact(pe._dt)
    assert h.tolist() == jh.astype(np.int64).tolist()
    assert c.tolist() == jc.tolist() and int(c.sum()) == n * (L - 20)


@pytest.mark.parametrize("shards,batch,match", [
    (3, 512, "power of two"), (8, 500, "divisible by n_shards")])
def test_bad_shard_settings_raise(lane, shards, batch, match):
    eng = Engine(EngineConfig(spec=HashSpec(k=K, w=W, seed=SEED),
                              batch_reads=batch, n_shards=shards), "cpu",
                 log=None)
    with pytest.raises(ValueError, match=match):
        eng.count(FB.load_fqb(lane))


def test_error_fix_and_checkpoint_gather_the_sharded_table(lane, tmp_path):
    """errorFix and save gather the sharded table; the checkpoint equals the
    single-device run's and reloads."""
    outs = []
    for n in (1, 4):
        eng = port_engine(n)
        fqb = FB.load_fqb(lane)
        eng.count(fqb)
        eng.error_fix(1, fqb=fqb, min_reads=2)
        eng.filter()
        eng.incidence(fqb)
        eng.cluster()
        eng.save(str(tmp_path / f"ck{n}.npz"))
        z = np.load(str(tmp_path / f"ck{n}.npz"))
        outs.append({k: z[k].tolist() for k in z.files if k != "meta"})
    assert outs[0] == outs[1]
