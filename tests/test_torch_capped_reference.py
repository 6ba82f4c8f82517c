"""The benchmark's plain reference of the capped-friend contract
(``benchmark/reference/capped_molecules.py``) against the port's capped
path (``Engine`` with ``max_friends > 0`` and
``cluster/cooccur.cluster_codes``) and the JAX package's oracle
(``cluster_barcode_friend``), on the CPU, exactly; and the capped path's
spans and counters.  The lanes are the benchmark's own
(``benchmark/lane.py``), seeded, with sequencing errors and reads off both
strands, at two densities, where caps of 1, 3 and 8 bind; hand-made
incidences add a barcode with no friend, share ties at the cap's edge and
barcodes of several size classes."""

import functools
import json

import numpy as np
import pytest
import torch

from benchmark.compare import compare
from benchmark.lane import make_lane
from benchmark.program import System, outputs
from benchmark.reference import capped_molecules, pipeline
from benchmark.run import HERE
from hash10x_tpu.oracle import cluster_ref as CO
from hash10x_tpu.table.incidence import build_incidence
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cluster import cooccur
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)
CPU = torch.device("cpu")

# the capped deployment's settings at a CPU test's size: 6 reads of 150 bp
# a barcode in one 3 kb molecule (0.3x), 48 barcodes; over 12 kb each
# k-mer lies in ~3.6 barcodes, over 4 kb in ~11
CFG = {"n_reads": 288, "n_barcodes": 48, "molecule_len": 3_000,
       "read_len": 150, "error_rate": 0.0024, "both_strands": True,
       "k": 21, "w": 11, "hash_seed": 17, "mode": "minimizer",
       "count_mode": "barcodes", "table_bits": 12, "batch_reads": 128,
       "flush_batches": 2, "band": [2, 64], "cluster_mode": "friend",
       "min_friend_share": 8, "max_friends": 256}
GENOMES = {"sparse": 12_000, "dense": 4_000}
SEED = 2**31 + 2401
CAPS = [1, 3, 8, 256]
SHARES = [1, 2, 8]


@functools.lru_cache(maxsize=None)
def _lane(density):
    return make_lane(CFG["n_reads"], CFG["n_barcodes"], GENOMES[density],
                     SEED, molecule=CFG["molecule_len"],
                     read_len=CFG["read_len"], error_rate=CFG["error_rate"],
                     both_strands=CFG["both_strands"])


def _traffic(thr, cap):
    t = json.loads((HERE / "traffic" / "capped.json").read_text())
    t["engine"] = dict(t["engine"], min_friend_share=thr, max_friends=cap)
    return t


def _hash_codes(offsets, kmers, n_kmers):
    offsets, kmers = offsets.tolist(), kmers.tolist()
    hash_codes = {k: [] for k in range(n_kmers)}
    for c in range(len(offsets) - 1):
        for k in kmers[offsets[c]:offsets[c + 1]]:
            hash_codes[k].append(c)
    return offsets, kmers, hash_codes


def _oracle(offsets, kmers, n_kmers, thr, cap):
    """``cluster_barcode_friend`` of every barcode, flat in forward-CSR
    order."""
    offsets, kmers, hash_codes = _hash_codes(offsets, kmers, n_kmers)
    out = []
    for c in range(len(offsets) - 1):
        out += CO.cluster_barcode_friend(kmers[offsets[c]:offsets[c + 1]],
                                         hash_codes, c, thr, cap)
    return out


def _friend_counts(offsets, kmers, n_kmers, thr):
    """Each barcode's friends at share >= ``thr``, from the oracle's
    shares."""
    offsets, kmers, hash_codes = _hash_codes(offsets, kmers, n_kmers)
    return np.array([sum(s >= thr for s in CO.barcode_shares(
        kmers[offsets[c]:offsets[c + 1]], hash_codes, c).values())
        for c in range(len(offsets) - 1)], dtype=np.int64)


def _recorded(mp, fn, *a, **kw):
    """(fn's result, the timer's stats, the rounds counted beside the
    program, through ``mp``, a monkeypatch)."""
    seen = {"rounds": 0}
    real = cooccur._propagate

    def prop(step, *b, **bk):
        def counted(lab):
            seen["rounds"] += 1
            return step(lab)
        return real(counted, *b, **bk)
    timer = StageTimer(None)
    mp.setattr(cooccur, "_propagate", prop)
    with timing.recording(timer):
        got = fn(*a, **kw)
    return got, timer.stats(), seen


def _cells(inc, thr, cap, max_batch_bytes=cooccur._BATCH_BYTES):
    """(batches, the B * K * F cells) of ``cluster_codes``' batches."""
    F = cooccur.friends_table(inc, thr, cap).shape[1]
    bs = list(cooccur._batches(inc, "friend", F, max_batch_bytes))
    return len(bs), sum(len(sel) * K * F for K, _, sel in bs)


def _check_counters(st, inc, thr, cap, rounds=None, **kw):
    """The capped path's spans and counters against counts by hand."""
    sizes = torch.diff(inc.code_offsets).numpy()
    friends = _friend_counts(inc.code_offsets, inc.code_kmers, inc.n_kmers,
                             thr)
    batches, cells = _cells(inc, thr, cap, **kw)
    assert st["cluster.capped.friends.n"] == 1
    assert st["cluster.cooccur.n"] == 1
    assert st["cluster.capped.member.n"] == st["cluster.capped.round.n"] \
        == batches >= 1
    assert st["cluster.capped_rounds"] >= batches
    if rounds is not None:
        assert st["cluster.capped_rounds"] == rounds
    assert st["cluster.capped_cut"] == int((friends > cap).sum())
    assert st["cluster.capped_real_cells"] == int(
        (sizes * np.minimum(friends, cap)).sum())
    assert st["cluster.capped_cells"] == cells \
        >= st["cluster.capped_real_cells"]
    assert not any(k.startswith("cluster.pair") for k in st)


@pytest.mark.parametrize("density", sorted(GENOMES))
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("thr", SHARES)
def test_the_pass_equals_the_reference_the_port_and_the_oracle(
        density, cap, thr):
    cfg = dict(CFG, genome_len=GENOMES[density], min_friend_share=thr,
               max_friends=cap)
    lane = _lane(density)
    traffic = _traffic(thr, cap)
    p = System(cfg, traffic, lane, CPU).run_pass()
    want, facts = capped_molecules.reference(lane, cfg, CPU)
    assert compare([outputs(p, traffic["compare"])], want) \
        == (dict.fromkeys(want, 0), 0)
    assert facts["emitted"] > want["pairs"][1].shape[0] > 0
    inc = p.engine.inc
    ref = want["labels"][0]
    port = cooccur.cluster_codes(inc, mode="friend", min_friend_share=thr,
                                 max_friends=cap)
    assert torch.equal(ref, port)
    assert ref.tolist() == _oracle(inc.code_offsets, inc.code_kmers,
                                   inc.n_kmers, thr, cap)
    # the reference's blocks: one barcode at a time gives the same labels
    assert torch.equal(capped_molecules.capped_clusters(
        inc.code_offsets, inc.code_kmers, inc.n_kmers, thr, cap,
        triples=1), ref)
    _check_counters(p.stats, inc, thr, cap)
    friends = _friend_counts(inc.code_offsets, inc.code_kmers, inc.n_kmers,
                             thr)
    if cap < 8:    # the cap binds on both lanes
        assert p.stats["cluster.capped_cut"] > 0 and friends.max() > cap
    if cap == 256:
        assert p.stats["cluster.capped_cut"] == 0


def test_the_cap_changes_the_molecules():
    """On the dense lane a cap of 1 leaves barcodes more molecules than a
    cap of 8, and 8 no fewer than 256: the cap is part of the contract."""
    lane = _lane("dense")
    cfg = dict(CFG, genome_len=GENOMES["dense"], min_friend_share=2)
    p = System(cfg, _traffic(2, 256), lane, CPU).run_pass()
    inc = p.engine.inc
    mol = {cap: pipeline.molecules(
        inc.code_offsets, capped_molecules.capped_clusters(
            inc.code_offsets, inc.code_kmers, inc.n_kmers, 2,
            cap))[0].shape[0] for cap in (1, 8, 256)}
    assert mol[1] > mol[8] >= mol[256]


def _incidence(pairs, n_kmers, n_codes):
    k, c = np.array(pairs).T
    return convert.incidence_from_numpy(
        build_incidence(k.astype(np.int32), c.astype(np.int32), n_kmers,
                        n_codes), "cpu")


def test_a_tie_at_the_caps_edge_goes_to_the_smaller_id(monkeypatch):
    """Barcode 0 holds k-mers 0-3; barcodes 3 and 7 each share two of them
    (a tie at share 2), 3 holding k-mers 0 and 1, 7 holding 2 and 3;
    barcode 5 holds k-mer 4 alone, and so has no friend.  With one friend
    kept, barcode 0's friend is barcode 3."""
    pairs = [(k, 0) for k in range(4)] + [(0, 3), (1, 3), (2, 7), (3, 7),
                                          (4, 5), (5, 3), (6, 7)]
    inc = _incidence(pairs, 7, 8)
    for cap, want in ((1, [0, 0, 1, 2]), (2, [0, 0, 1, 1])):
        got, st, seen = _recorded(monkeypatch, cooccur.cluster_codes, inc,
                                  min_friend_share=2, max_friends=cap)
        assert got[:4].tolist() == want
        # barcode 5: one k-mer, no friend; 3 and 7: one friend each
        assert got.tolist() == want + [0, 0, 1, 0, 0, 0, 1]
        assert got.tolist() == _oracle(inc.code_offsets, inc.code_kmers,
                                       inc.n_kmers, 2, cap)
        assert torch.equal(got, capped_molecules.capped_clusters(
            inc.code_offsets, inc.code_kmers, inc.n_kmers, 2, cap))
        _check_counters(st, inc, 2, cap, seen["rounds"])
        assert st["cluster.capped_cut"] == (1 if cap == 1 else 0)
    # share 3: no barcode has a friend, every k-mer is a molecule
    got = cooccur.cluster_codes(inc, min_friend_share=3, max_friends=1)
    assert got.tolist() == [0, 1, 2, 3, 0, 1, 2, 0, 0, 1, 2]
    assert torch.equal(got, capped_molecules.capped_clusters(
        inc.code_offsets, inc.code_kmers, inc.n_kmers, 3, 1))


def _random_incidence(rng, sizes, n_kmers, density, helpers=24):
    """Barcodes of the given k-mer counts over ``n_kmers`` k-mers, then
    ``helpers`` barcodes that hold each k-mer at ``density``: the
    friends."""
    ks, cs = [], []
    for c, n in enumerate(sizes):
        ks += rng.choice(n_kmers, size=n, replace=False).tolist()
        cs += [c] * n
    k, h = np.nonzero(rng.random((n_kmers, helpers)) < density)
    ks += k.tolist()
    cs += (h + len(sizes)).tolist()
    return convert.incidence_from_numpy(
        build_incidence(np.array(ks, np.int32), np.array(cs, np.int32),
                        n_kmers, len(sizes) + helpers), "cpu")


@pytest.mark.parametrize("thr,cap,density", [(1, 1, 0.05), (2, 3, 0.12),
                                             (3, 8, 0.2), (2, 256, 0.2)])
def test_mixed_size_barcodes_in_several_batches(thr, cap, density,
                                                monkeypatch):
    rng = np.random.default_rng(thr * 100 + cap)
    # size classes 8 (a one-k-mer barcode among them) up to 128, two empty
    # barcodes
    sizes = [1, 0, 3, 9, 17, 40, 70, 100, 0, 5, 33, 64, 65, 12]
    inc = _random_incidence(rng, sizes, 120, density)
    n_per = torch.diff(inc.code_offsets)
    classes = {cooccur._size_class(int(n)) for n in n_per if n}
    assert n_per[:len(sizes)].tolist() == sizes and len(classes) >= 5
    # a byte budget of a few rows: several batches in a size class
    got, st, seen = _recorded(monkeypatch, cooccur.cluster_codes, inc,
                              min_friend_share=thr, max_friends=cap,
                              max_batch_bytes=1 << 16)
    _check_counters(st, inc, thr, cap, seen["rounds"],
                    max_batch_bytes=1 << 16)
    assert torch.equal(got, capped_molecules.capped_clusters(
        inc.code_offsets, inc.code_kmers, inc.n_kmers, thr, cap,
        triples=500))
    assert got.tolist() == _oracle(inc.code_offsets, inc.code_kmers,
                                   inc.n_kmers, thr, cap)
    assert torch.equal(got, cooccur.cluster_codes(
        inc, min_friend_share=thr, max_friends=cap))
    assert st["cluster.capped.member.n"] > len(classes)
    # friend_union_batch, both halves in one call, batch by batch
    table = cooccur.friends_table(inc, thr, cap)
    whole = torch.full_like(got, -1)
    for K, C, sel in cooccur._batches(inc, "friend", table.shape[1],
                                      1 << 16):
        chunk = torch.from_numpy(sel)
        pos, valid, cl = cooccur.batch_lists(inc, chunk, K, C)
        whole[pos[valid]] = cooccur.friend_union_batch(
            cl, valid, table[chunk])[valid]
    assert torch.equal(whole, got)


def test_nothing_is_recorded_without_a_timer_or_in_other_modes(
        monkeypatch):
    inc = _random_incidence(np.random.default_rng(7), [4, 9, 20], 40, 0.2)
    cooccur.cluster_codes(inc, max_friends=4)   # no timer: nothing to record
    for kw in ({"mode": "pair"}, {"max_friends": 0, "min_friend_share": 1}):
        _, st, _ = _recorded(monkeypatch, cooccur.cluster_codes, inc, **kw)
        assert st and not any("capped" in k for k in st)


def test_the_reference_refuses_other_contracts():
    lane = _lane("sparse")
    for kw in ({"cluster_mode": "pair"}, {"max_friends": 0}):
        cfg = dict(CFG, genome_len=GENOMES["sparse"], **kw)
        with pytest.raises(ValueError):
            capped_molecules.reference(lane, cfg, CPU)
