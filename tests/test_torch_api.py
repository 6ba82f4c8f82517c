"""The port's public engine surface against the JAX package's:
``build_incidence``, ``retained_lookup``, ``Incidence.kmers_of``/``codes_of``,
``friend_pairs``, ``Engine.reset``, ``Engine.clusters``, and the sketch
entry points ``sketch_minimizer``, ``sketch_minimizer_compact`` and
``supported``.  ``Engine.stats`` is held against the port's own step and
flush counts (one dispatch per step of up to ``flush_batches`` batches,
sharded or not, as the JAX engine counts its scan-fused dispatches).  Every
comparison is exact (tolerance: none)."""

import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hash10x_tpu.cluster import sparse as JSP
from hash10x_tpu.engine import Engine as JEngine, EngineConfig as JConfig
from hash10x_tpu.hashspec import HashSpec as JHashSpec
from hash10x_tpu.io import fqb as JFB
from hash10x_tpu.io.sim import SimConfig, simulate
from hash10x_tpu.kernels import minimizer_pallas as MP
from hash10x_tpu.table import incidence as JI
from hash10x_tpu.table import sorted_table as JST
from hash10x_tpu_torch import INT64_MAX
from hash10x_tpu_torch.cluster import sparse as SP
from hash10x_tpu_torch.engine import Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io import fqb as FB
from hash10x_tpu_torch.kernels import minimizer as MK
from hash10x_tpu_torch.table import incidence as TI
from hash10x_tpu_torch.table import sorted_table as st

torch.set_num_threads(2)

SLOTS = re.compile(r"^table slots \d+ ", re.M)
U64MAX = np.uint64(2**64 - 1)
FIELDS = ("code_offsets", "code_kmers", "kmer_offsets", "kmer_codes",
          "inv2fwd")


def _flat_emissions(seed, n_kmers, n_codes, n):
    """Flat (k-mer id, barcode id) emissions with -1 entries and
    duplicates."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, max(n_kmers, 1), size=n).astype(np.int32)
    c = rng.integers(0, max(n_codes, 1), size=n).astype(np.int32)
    k[rng.random(n) < 0.1] = -1
    c[rng.random(n) < 0.1] = -1
    dup = rng.integers(0, n, size=n // 3)
    return np.concatenate([k, k[dup]]), np.concatenate([c, c[dup]])


def _same_incidence(got, want):
    assert (got.n_kmers, got.n_codes, got.n_pairs) == \
        (want.n_kmers, want.n_codes, want.n_pairs)
    for f in FIELDS:
        w = getattr(want, f)
        g = getattr(got, f).numpy()
        if w is None:   # the JAX package's empty incidence has no inv2fwd
            assert want.n_pairs == 0 and len(g) == 0
            continue
        assert g.tolist() == np.asarray(w).tolist(), f


@pytest.mark.parametrize("n_kmers,n_codes,n", [
    (50, 7, 400), (300, 40, 2000), (1, 1, 10), (20, 3, 0), (10, 0, 30)])
def test_build_incidence_equals_jax(n_kmers, n_codes, n):
    k, c = _flat_emissions(n_kmers * 131 + n, n_kmers, n_codes, n)
    if n_codes == 0:
        c[:] = -1
    want = JI.build_incidence(k, c, n_kmers=n_kmers, n_codes=n_codes)
    got = TI.build_incidence(k, c, n_kmers, n_codes, "cpu")
    _same_incidence(got, want)
    if want.n_pairs:
        for code in range(n_codes):
            assert got.kmers_of(code).tolist() == \
                want.kmers_of(code).tolist()
        for kmer in range(n_kmers):
            assert got.codes_of(kmer).tolist() == \
                want.codes_of(kmer).tolist()


def test_build_incidence_limits():
    k = np.array([0, 5], np.int32)
    c = np.array([0, 1], np.int32)
    with pytest.raises(ValueError, match="does not fit int64"):
        TI.build_incidence(k, c, 1 << 40, 1 << 23, "cpu")
    with pytest.raises(ValueError, match="must be <"):
        TI.build_incidence(k, c, 5, 2, "cpu")


def test_retained_lookup_equals_jax():
    rng = np.random.default_rng(8)
    retained = np.unique(rng.integers(0, 1 << 42, size=500)).astype(np.uint64)
    q = np.concatenate([retained[rng.integers(0, len(retained), 300)],
                        rng.integers(0, 1 << 42, size=300).astype(np.uint64),
                        np.array([0, retained[-1] + 1, U64MAX], np.uint64)])
    for ret in (retained, retained[:0]):
        jid, jfound = JI.retained_lookup(ret, q)
        pid, pfound = TI.retained_lookup(
            torch.from_numpy(ret.astype(np.int64)),
            torch.from_numpy(np.where(q == U64MAX, INT64_MAX,
                                      q.astype(np.int64))))
        assert pid.tolist() == jid.tolist()
        assert pfound.tolist() == jfound.tolist()
    assert jfound.sum() == 0 and pfound.dtype == torch.bool


def test_friend_pairs_equal_jax():
    k, c = _flat_emissions(3, 60, 30, 3000)
    jinc = JI.build_incidence(k, c, n_kmers=60, n_codes=30)
    keys, shares = JSP.cooccurrence_counts(jinc)
    tk = torch.from_numpy(keys.astype(np.int64))
    ts = torch.from_numpy(shares.astype(np.int64))
    # the port's own c1 < c2 co-occurrence counts
    pk, ps = SP.cooccurrence_counts(TI.build_incidence(k, c, 60, 30, "cpu"))
    for thr in (1, 3, 6, 1000):
        want = JSP.friend_pairs(keys, shares, thr)
        assert SP.friend_pairs(tk, ts, thr).tolist() == \
            want.astype(np.int64).tolist()
        half = want[(want // 30) < (want % 30)]
        assert SP.friend_pairs(pk, ps, thr).tolist() == \
            half.astype(np.int64).tolist()


# -- the engine: reset, stats, clusters ---------------------------------------

def _sim_reads():
    sim = simulate(SimConfig(genome_len=60_000, n_barcodes=40,
                             molecules_per_barcode=2, molecule_len=4000,
                             reads_per_molecule=20, read_len=100,
                             error_rate=0.003, seed=6))
    return sim.reads


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("api") / "lane.fqb")
    JFB.save_fqb(path, JFB.from_read_batch(_sim_reads()))
    return path


def _cfgs(count_mode="barcodes", n_shards=1):
    kw = dict(table_bits=12, batch_reads=512, count_mode=count_mode,
              min_count=2, max_count=40, min_friend_share=4)
    return (JConfig(spec=JHashSpec(k=17, w=7, seed=17), **kw),
            EngineConfig(spec=HashSpec(k=17, w=7, seed=17),
                         n_shards=n_shards, **kw))


def _table(eng):
    h, c = st.compact(eng._flushed())
    return h.tolist(), c.tolist()


@pytest.mark.parametrize("count_mode", ["occurrences", "barcodes"])
def test_reset_then_count_equals_fresh_and_jax(lane, count_mode):
    jcfg, cfg = _cfgs(count_mode)
    jeng = JEngine(jcfg, log=None)
    jeng.count(JFB.load_fqb(lane))
    jeng.reset()
    jeng.count(JFB.load_fqb(lane))
    jh, jc = JST.compact(jeng._flushed())
    fqb = FB.load_fqb(lane)
    fresh = Engine(cfg, "cpu", log=None)
    fresh.count(fqb)
    eng = Engine(cfg, "cpu", log=None)
    eng.count(fqb)
    eng.filter()
    lane_dev = eng._lane_cache[2]
    eng.reset()
    assert eng.table is None and eng.retained_hashes is None
    assert eng.n_reads_counted == 0 and _zeroed(eng.stats)
    eng.count(fqb)
    assert eng._lane_cache[2] is lane_dev      # the lane stayed on the device
    assert _table(eng) == _table(fresh)
    assert _table(eng) == (jh.astype(np.int64).tolist(), jc.tolist())
    assert eng.n_reads_counted == jeng.n_reads_counted == fresh.n_reads_counted


def _pipeline(eng, fqb):
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    out = io.StringIO()
    eng.report(out)
    return out.getvalue()


@pytest.mark.parametrize("n_shards", [1, 2])
def test_reset_then_pipeline_gives_jax_report(lane, n_shards):
    jcfg, cfg = _cfgs(n_shards=n_shards)
    want = _pipeline(JEngine(jcfg, log=None), JFB.load_fqb(lane))
    assert "code 39 nKmers" in want
    fqb = FB.load_fqb(lane)
    eng = Engine(cfg, "cpu", log=None)
    assert _pipeline(eng, fqb) == want
    eng.split()
    group = eng._group
    eng.reset()
    assert eng._dt is None and eng._ret_sh is None and eng._inc_sh is None
    assert eng.inc is None and eng.cluster_labels is None
    assert eng.split_inc is None and eng.split_origin is None
    assert eng._mol_cache is None and eng.clusters is None
    assert eng._group is group                 # a sharded run does not re-join
    assert _pipeline(eng, fqb) == want


def _zeroed(stats):
    """Stats of a fresh or reset engine: its counters, all 0, no span."""
    return stats["dispatches"] == stats["flushes"] == 0 and not any(
        stats.values()) and not any("." in k for k in stats)


def _counts(stats):
    return {k: stats[k] for k in ("dispatches", "flushes")}


class _FlushSpy:
    """Counts the sort-merges (``flush_grow`` calls on a non-empty
    buffer) wherever they happen."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = st.flush_grow

        def spy(t, *a, **kw):
            self.n += t.buf_n > 0
            return real(t, *a, **kw)
        monkeypatch.setattr(st, "flush_grow", spy)


@pytest.mark.parametrize("n_shards,batch,flush_batches", [
    (1, 512, 16), (1, 64, 16), (1, 64, 3), (1, 64, 1), (2, 256, 16)])
def test_stats_count_batches_and_flushes(lane, monkeypatch, n_shards, batch,
                                         flush_batches):
    _, cfg = _cfgs(n_shards=n_shards)
    cfg.batch_reads = batch
    cfg.flush_batches = flush_batches
    fqb = FB.load_fqb(lane)
    eng = Engine(cfg, "cpu", log=None)
    spans = eng._lane(fqb)[1]
    assert all(gid is None for *_, gid in spans)   # no oversized barcode
    n_batches = len(spans)
    # one device step per flush_batches batches, sharded or not
    n_steps = -(-n_batches // flush_batches)
    assert n_steps < n_batches or flush_batches == 1
    spy = _FlushSpy(monkeypatch)
    eng.count(fqb)
    assert _counts(eng.stats) == {"dispatches": n_steps, "flushes": spy.n}
    assert spy.n >= 1
    before = _counts(eng.stats)
    spy.n = 0
    eng.filter()
    eng.incidence(fqb)
    assert {k: v - before[k] for k, v in _counts(eng.stats).items()} == \
        {"dispatches": n_steps, "flushes": spy.n}
    if batch == 64:   # 16 batches fill the append buffer: more merges
        assert spy.n > 1
    eng.reset()
    assert _zeroed(eng.stats)


def test_clusters_equal_jax_view(lane):
    jcfg, cfg = _cfgs()
    jeng = JEngine(jcfg, log=None)
    _pipeline(jeng, JFB.load_fqb(lane))
    eng = Engine(cfg, "cpu", log=None)
    assert eng.clusters is None
    _pipeline(eng, FB.load_fqb(lane))
    got, want = eng.clusters, jeng.clusters
    assert len(got) == len(want) == 40
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert sum(len(g) for g in got) == eng.inc.n_pairs


# -- the sketch entry points --------------------------------------------------

def test_sketch_minimizer_equals_pallas(rng):
    """Dense rows, B = 1024 and reads of k + w - 1 bases or more (the
    Pallas kernel's domain; interpret mode off the TPU)."""
    codes = rng.integers(0, 4, size=(1024, 96)).astype(np.uint8)
    lengths = rng.integers(27, 97, size=1024).astype(np.int32)
    lengths[:5] = 0
    h1, f1, e1 = (np.asarray(x) for x in MP.sketch_minimizer(
        JHashSpec(k=21, w=7, seed=17), jnp.asarray(codes),
        jnp.asarray(lengths)))
    h2, f2, e2 = (x.numpy() for x in MK.sketch_minimizer(
        HashSpec(k=21, w=7, seed=17), torch.from_numpy(codes),
        torch.from_numpy(lengths)))
    assert (e1 == e2).all() and e2.any()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all()
    valid = h1 != U64MAX
    assert (h1[valid].astype(np.int64) == h2[valid]).all()
    assert (h2[~valid] == INT64_MAX).all()


def test_sketch_minimizer_compact_equals_pallas(rng):
    k, w, C = 17, 3, 8
    codes = rng.integers(0, 4, size=(1024, 64)).astype(np.uint8)
    lengths = rng.integers(k + w - 1, 65, size=1024).astype(np.int32)
    h1, f1, e1, ov1 = (np.asarray(x) for x in MP.sketch_minimizer_compact(
        JHashSpec(k=k, w=w, seed=17), jnp.asarray(codes),
        jnp.asarray(lengths), C))
    h2, f2, e2, ov2 = (x.numpy() for x in MK.sketch_minimizer_compact(
        HashSpec(k=k, w=w, seed=17), torch.from_numpy(codes),
        torch.from_numpy(lengths), C))
    assert (ov1 == ov2).all() and ov2.max() > 0
    assert (e1 == e2).all()
    assert (h1[e1].astype(np.int64) == h2[e2]).all()
    assert (f1[e1] == f2[e2]).all() and (h2[~e2] == INT64_MAX).all()


@pytest.mark.parametrize("mode,kw", [
    ("minimizer", {}), ("kmer", {}), ("modimizer", {}),
    ("modimizer", {"m": 7}), ("modimizer", {"m": 1}),
    ("modimizer", {"m": 1 << 16}), ("syncmer", {"syncmer_s": 11}),
    ("syncmer", {"syncmer_s": 0}), ("syncmer", {"syncmer_s": 21}),
    ("bogus", {})])
def test_supported_covers_the_pallas_domain(mode, kw):
    """Where the Pallas kernel takes a batch, so does the CUDA kernel; it
    also takes what the Pallas kernel leaves to the jnp path (B not a
    multiple of 1,024, reads shorter than w k-mers, m = 1 or m >= 2^16),
    and refuses what ``sketch`` raises on."""
    jspec, spec = JHashSpec(k=21, w=11, seed=17), HashSpec(k=21, w=11,
                                                           seed=17)
    for shape in ((1024, 150), (1024, 30), (1024, 21), (1024, 20),
                  (1000, 150), (0, 150)):
        j = MP.supported(jspec, shape, mode, **kw)
        p = MK.supported(spec, shape, mode, **kw)
        if j:
            assert p, (shape, mode, kw)
        refused = (mode == "bogus" or shape[1] < 21
                   or (mode == "syncmer" and not 0 < kw["syncmer_s"] < 21))
        assert p == (not refused), (shape, mode, kw)
