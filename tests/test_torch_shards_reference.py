"""The engine's main pass at 1, 2 and 4 shards against the benchmark's plain
reference (``benchmark/reference/molecules.py``), on the CPU: band, pairs,
labels, molecules and report lines, exactly.  The lanes are the
benchmark's own (``benchmark/lane.py``): seeded, with sequencing errors and
reads off both strands, ~20 barcodes a k-mer.  One case starts with send
lanes too narrow for a batch, so the sharded passes overflow and run again
with doubled lanes; and the sharded clustering's edges, in blocks of any
size and under label blocks, give the one-card path's labels: on the CPU
by rounds, which record no union-find edges, and on a card (``-m chip``,
``python -m pytest -q --noconftest -m chip
tests/test_torch_shards_reference.py``) by one union-find sweep."""

import dataclasses
import functools
import json

import pytest
import torch

from benchmark.compare import compare
from benchmark.lane import make_lane
from benchmark.program import System, outputs
from benchmark.reference import molecules
from benchmark.run import HERE
import hash10x_tpu_torch.cluster.sparse_dist as SPD
from hash10x_tpu_torch.cluster.sparse import cluster_codes_sparse
from hash10x_tpu_torch.dist.group import ShardGroup
from hash10x_tpu_torch.kernels import union_find as UF
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)
CPU = torch.device("cpu")

# the slice's configuration at a CPU test's size: 40 reads of 150 bp in one
# 30 kb molecule a barcode, 0.24% errors; 240 barcodes over 60 kb put each
# k-mer in ~21 barcodes (240 x 30,000 / 60,000 x 0.173)
CFG = {"n_reads": 9600, "n_barcodes": 240, "genome_len": 60_000,
       "molecule_len": 30_000, "read_len": 150, "error_rate": 0.0024,
       "both_strands": True, "k": 21, "w": 11, "hash_seed": 17,
       "mode": "minimizer", "count_mode": "barcodes", "table_bits": 12,
       "batch_reads": 1024, "flush_batches": 4, "band": [2, 64],
       "min_friend_share": 8, "cluster_mode": "friend", "max_friends": 0}
SEEDS = [2**31 + 17, 3_000_017_101]


@functools.lru_cache(maxsize=None)
def _lane(seed):
    return make_lane(CFG["n_reads"], CFG["n_barcodes"], CFG["genome_len"],
                     seed, molecule=CFG["molecule_len"],
                     read_len=CFG["read_len"], error_rate=CFG["error_rate"],
                     both_strands=CFG["both_strands"])


@functools.lru_cache(maxsize=None)
def _want(seed):
    return molecules.reference(_lane(seed), CFG, CPU)[0]


def _traffic(**engine):
    t = json.loads((HERE / "traffic" / "shards4.json").read_text())
    t["engine"] = engine
    return t


@functools.lru_cache(maxsize=None)
def _checks(seed, **engine):
    """(the checks' numbers, the pass) of one pass of the shards4 mix."""
    traffic = _traffic(**engine)
    p = System(CFG, traffic, _lane(seed), CPU).run_pass()
    values, failed = compare([outputs(p, traffic["compare"])], _want(seed))
    return values, failed, p


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_the_pass_equals_the_plain_reference(seed, n_shards):
    values, failed, p = _checks(seed, n_shards=n_shards)
    assert values == dict.fromkeys(_want(seed), 0) and failed == 0
    # dense enough for the friend graph to join a barcode's k-mers into
    # about its one molecule
    inc = p.engine.inc
    assert inc.n_pairs > 15 * p.engine.retained_hashes.shape[0]
    assert inc.n_pairs > 100 * CFG["n_barcodes"]
    assert p.engine.split_origin.shape[0] < 2 * CFG["n_barcodes"]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_the_cpu_propagates_in_rounds_without_the_kernel(n_shards):
    stats = _checks(SEEDS[0], n_shards=n_shards)[2].stats
    assert stats["cluster.uf_edges"] == 0 == stats["cluster.uf_hooks"]
    assert stats["cluster.round.n"] >= 1


def test_lanes_too_narrow_run_again_and_equal_the_reference():
    seed = SEEDS[0]
    values, failed, p = _checks(seed, n_shards=4, lane_capacity=1024)
    assert values == dict.fromkeys(_want(seed), 0) and failed == 0
    assert p.stats["shard.sweep_retries"] >= 1
    assert p.engine.cfg.lane_capacity > 1024


@functools.lru_cache(maxsize=None)
def _inc(seed):
    _, _, p = _checks(seed, n_shards=1)
    return p.engine.inc


@pytest.mark.parametrize("edge_block,label_blocks", [
    (1, 0), (777, 0), (1 << 25, 0), (5000, 2000)])
def test_edge_blocks_give_the_one_card_labels(edge_block, label_blocks):
    inc = _inc(SEEDS[1])
    want = cluster_codes_sparse(inc, CFG["min_friend_share"])
    got = SPD.cluster_codes_sparse_dist(
        inc, ShardGroup(4, CPU), CFG["min_friend_share"], flat=True,
        label_block_pairs=label_blocks, edge_block=edge_block)
    assert torch.equal(got, want)
    if edge_block < 1 << 25:
        assert SPD.STATS["edge_blocks"] > 4
    assert SPD.STATS["edges"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("label_blocks", [0, 2000])
def test_one_sweep_on_a_card_gives_the_one_card_labels(n_shards,
                                                       label_blocks):
    """One process on CUDA: one union-find call per label block over every
    shard's edge blocks, no rounds, every edge hooked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inc = _inc(SEEDS[1])
    inc = dataclasses.replace(inc, **{
        f.name: getattr(inc, f.name).cuda() for f in dataclasses.fields(inc)
        if torch.is_tensor(getattr(inc, f.name))})
    want = cluster_codes_sparse(inc, CFG["min_friend_share"])
    timer = StageTimer(None, device="cuda")
    before = UF.LAUNCHES
    with timing.recording(timer):
        got = SPD.cluster_codes_sparse_dist(
            inc, ShardGroup(n_shards, "cuda"), CFG["min_friend_share"],
            flat=True, label_block_pairs=label_blocks, edge_block=5000)
    assert torch.equal(got, want)
    stats = timer.stats()
    sweeps = SPD.STATS.get("label_blocks", 1)
    assert sweeps > 1 if label_blocks else sweeps == 1
    assert UF.LAUNCHES - before == SPD.STATS["rounds"] == sweeps \
        == stats["cluster.round.n"]
    assert stats["cluster.uf_edges"] == SPD.STATS["edges"] > 0
    assert SPD.STATS["edge_blocks"] > n_shards
