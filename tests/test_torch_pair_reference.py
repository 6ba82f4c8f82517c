"""The benchmark's plain reference of the pair contract
(``benchmark/reference/pair_molecules.py``) against the port's pair path
(``Engine`` in pair mode and ``cluster/cooccur.cluster_codes``) and the JAX
package's oracle (``cluster_barcode``), on the CPU, exactly; and the pair
path's spans and counters.  The lanes are the benchmark's own
(``benchmark/lane.py``), seeded, with sequencing errors and reads off both
strands, at two densities; hand-made incidences add a barcode of one
k-mer, empty barcodes and barcodes of several size classes."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from benchmark.compare import compare
from benchmark.lane import make_lane
from benchmark.program import System, outputs
from benchmark.reference import pair_molecules, pipeline
from benchmark.run import HERE
from hash10x_tpu.oracle import cluster_ref as CO
from hash10x_tpu.table.incidence import build_incidence
from hash10x_tpu_torch import convert
from hash10x_tpu_torch.cluster import cooccur
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)
CPU = torch.device("cpu")

# the pair deployment's settings at a CPU test's size: 6 reads of 150 bp a
# barcode in one 3 kb molecule (0.3x), 48 barcodes; over 12 kb each k-mer
# lies in ~3.6 barcodes, over 4 kb in ~11
CFG = {"n_reads": 288, "n_barcodes": 48, "molecule_len": 3_000,
       "read_len": 150, "error_rate": 0.0024, "both_strands": True,
       "k": 21, "w": 11, "hash_seed": 17, "mode": "minimizer",
       "count_mode": "barcodes", "table_bits": 12, "batch_reads": 128,
       "flush_batches": 2, "band": [2, 64], "cluster_mode": "pair",
       "min_share": 2}
GENOMES = {"sparse": 12_000, "dense": 4_000, "merged": 12_000}
SEED = 2**31 + 2201


@functools.lru_cache(maxsize=None)
def _lane(density):
    if density == "merged":
        return _merged()
    return make_lane(CFG["n_reads"], CFG["n_barcodes"], GENOMES[density],
                     SEED, molecule=CFG["molecule_len"],
                     read_len=CFG["read_len"], error_rate=CFG["error_rate"],
                     both_strands=CFG["both_strands"])


def _merged():
    """The sparse lane with the reads of a barcode that shares no k-mer
    with barcode 0 given to barcode 0, which then holds two molecules."""
    lane = _lane("sparse")
    offsets, kmers = pipeline.band_and_incidence(
        *pipeline.on_device(lane, CPU), lane.read_len, lane.n_codes,
        CFG["k"], CFG["w"], CFG["hash_seed"], *CFG["band"])[2:4]
    sets = [set(kmers[offsets[c]:offsets[c + 1]].tolist())
            for c in range(lane.n_codes)]
    j = max((c for c in range(1, lane.n_codes) if not sets[c] & sets[0]),
            key=lambda c: len(sets[c]))
    ids = np.where(lane.barcode_ids == j, 0, lane.barcode_ids)
    o = np.argsort(ids, kind="stable")
    return dataclasses.replace(
        lane, packed=lane.packed[o], lengths=lane.lengths[o],
        barcode_ids=ids[o].astype(np.int32))


def _traffic(min_share):
    t = json.loads((HERE / "traffic" / "pair.json").read_text())
    t["engine"] = dict(t["engine"], min_share=min_share)
    return t


def _oracle(offsets, kmers, n_kmers, min_share):
    """``cluster_barcode`` of every barcode, flat in forward-CSR order."""
    offsets, kmers = offsets.tolist(), kmers.tolist()
    hash_codes = {k: [] for k in range(n_kmers)}
    for c in range(len(offsets) - 1):
        for k in kmers[offsets[c]:offsets[c + 1]]:
            hash_codes[k].append(c)
    out = []
    for c in range(len(offsets) - 1):
        out += CO.cluster_barcode(kmers[offsets[c]:offsets[c + 1]],
                                  hash_codes, min_share)
    return out


def _recorded(mp, fn, *a, **kw):
    """(fn's result, the timer's stats, the batches, rounds and cells
    counted beside the program, through ``mp``, a monkeypatch)."""
    seen = {"batches": 0, "rounds": 0, "cells": 0}
    real_batch, real_prop = cooccur.cluster_batch, cooccur._propagate

    def batch(cl, *b, **bk):
        seen["batches"] += 1
        seen["cells"] += cl.shape[0] * cl.shape[1] ** 2
        return real_batch(cl, *b, **bk)

    def prop(step, *b, **bk):
        def counted(lab):
            seen["rounds"] += 1
            return step(lab)
        return real_prop(counted, *b, **bk)
    timer = StageTimer(None)
    mp.setattr(cooccur, "cluster_batch", batch)
    mp.setattr(cooccur, "_propagate", prop)
    with timing.recording(timer):
        got = fn(*a, **kw)
    return got, timer.stats(), seen


@pytest.mark.parametrize("density", ["sparse", "dense"])
@pytest.mark.parametrize("min_share", [1, 2, 3])
def test_the_pass_equals_the_plain_reference(density, min_share):
    cfg = dict(CFG, genome_len=GENOMES[density], min_share=min_share)
    lane = _lane(density)
    traffic = _traffic(min_share)
    p = System(cfg, traffic, lane, CPU).run_pass()
    want, facts = pair_molecules.reference(lane, cfg, CPU)
    assert compare([outputs(p, traffic["compare"])], want) \
        == (dict.fromkeys(want, 0), 0)
    assert facts["emitted"] > want["pairs"][1].shape[0] > 0
    # the spans and counters of the engine's pass
    st = p.stats
    assert st["cluster.pair.support.n"] == st["cluster.pair.round.n"] \
        == st["cluster.pair.lists.n"] >= 1
    assert st["cluster.pair_rounds"] >= st["cluster.pair.round.n"]
    sizes = torch.diff(want["pairs"][0])
    assert st["cluster.pair_real_cells"] == int((sizes ** 2).sum()) \
        <= st["cluster.pair_cells"]


@pytest.mark.parametrize("density", sorted(GENOMES))
@pytest.mark.parametrize("min_share", [1, 2, 3])
def test_the_reference_equals_the_port_and_the_oracle(density, min_share):
    lane = _lane(density)
    cfg = dict(CFG, genome_len=GENOMES[density])
    p = System(cfg, _traffic(min_share), lane, CPU).run_pass()
    inc = p.engine.inc
    ref = pair_molecules.pair_clusters(inc.code_offsets, inc.code_kmers,
                                       inc.n_kmers, min_share)
    port = cooccur.cluster_codes(inc, min_share=min_share, mode="pair")
    assert torch.equal(ref, port)
    assert ref.tolist() == _oracle(inc.code_offsets, inc.code_kmers,
                                   inc.n_kmers, min_share)
    # the reference's blocks: one barcode at a time gives the same labels
    assert torch.equal(pair_molecules.pair_clusters(
        inc.code_offsets, inc.code_kmers, inc.n_kmers, min_share,
        cells=1), ref)
    sizes = torch.diff(inc.code_offsets)
    per_code = torch.zeros(inc.n_codes, dtype=torch.int64).scatter_reduce_(
        0, inc.code_of_pair(), ref + 1, "amax")
    if density == "merged":
        # barcode 0 holds two molecules with no k-mer in common; one other
        # barcode whose molecule spans both may join them at min_share 1
        assert (sizes == 0).sum() == 1 and sizes[0] > sizes.float().mean()
        assert per_code[0] >= (1 if min_share == 1 else 2)
    # links join k-mers: fewer molecules than k-mers
    assert per_code.sum() < inc.n_pairs


def _incidence(rng, sizes, n_kmers, density, helpers=24):
    """Barcodes of the given k-mer counts over ``n_kmers`` k-mers, then
    ``helpers`` barcodes that hold each k-mer at ``density``: the others'
    support."""
    ks, cs = [], []
    for c, n in enumerate(sizes):
        ks += rng.choice(n_kmers, size=n, replace=False).tolist()
        cs += [c] * n
    k, h = np.nonzero(rng.random((n_kmers, helpers)) < density)
    ks += k.tolist()
    cs += (h + len(sizes)).tolist()
    return build_incidence(np.array(ks, np.int32), np.array(cs, np.int32),
                           n_kmers, len(sizes) + helpers)


@pytest.mark.parametrize("min_share,density", [(1, 0.05), (2, 0.12),
                                               (3, 0.2)])
def test_one_kmer_empty_and_mixed_size_barcodes(min_share, density,
                                                monkeypatch):
    rng = np.random.default_rng(min_share)
    # size classes 8 (the one-k-mer barcode among them) up to 128, two
    # empty barcodes
    sizes = [1, 0, 3, 9, 17, 40, 70, 100, 0, 5, 33, 64, 65, 12]
    inc_np = _incidence(rng, sizes, 120, density)
    inc = convert.incidence_from_numpy(inc_np, "cpu")
    n_per = torch.diff(inc.code_offsets)
    classes = {cooccur._size_class(int(n)) for n in n_per if n}
    assert n_per[:len(sizes)].tolist() == sizes and len(classes) >= 5
    # a byte budget of a few rows: several batches in a size class
    got, stats, seen = _recorded(monkeypatch, cooccur.cluster_codes, inc,
                                 min_share=min_share, mode="pair",
                                 max_batch_bytes=1 << 16)
    ref = pair_molecules.pair_clusters(inc.code_offsets, inc.code_kmers,
                                       inc.n_kmers, min_share, cells=5000)
    assert torch.equal(got, ref)
    assert got.tolist() == _oracle(inc.code_offsets, inc.code_kmers,
                                   inc.n_kmers, min_share)
    # one span of each kind a batch, the rounds run, the cells computed
    assert stats["cluster.pair.support.n"] == stats["cluster.pair.round.n"] \
        == stats["cluster.pair.lists.n"] == seen["batches"] > len(classes)
    assert stats["cluster.pair_rounds"] == seen["rounds"] \
        >= seen["batches"]
    assert stats["cluster.pair_cells"] == seen["cells"]
    assert stats["cluster.pair_real_cells"] == int((n_per ** 2).sum()) \
        < stats["cluster.pair_cells"]


def test_nothing_is_recorded_without_a_timer_or_in_friend_modes(
        monkeypatch):
    inc = convert.incidence_from_numpy(
        _incidence(np.random.default_rng(7), [4, 9, 20], 40, 0.2), "cpu")
    cooccur.cluster_codes(inc, mode="pair")   # no timer: nothing to record
    _, stats, seen = _recorded(monkeypatch, cooccur.cluster_codes, inc,
                               min_friend_share=1, max_friends=4)
    assert seen["batches"] == 0
    assert not any(k.startswith("cluster.pair") for k in stats)


def test_the_reference_refuses_the_friend_contract():
    cfg = dict(CFG, genome_len=GENOMES["sparse"], cluster_mode="friend")
    with pytest.raises(ValueError):
        pair_molecules.reference(_lane("sparse"), cfg, CPU)
