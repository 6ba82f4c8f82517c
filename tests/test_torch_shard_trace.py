"""The spans and counters of the sharded path (``dist/``,
``cluster/sparse_dist.py``), exported per pass through ``Engine.stats``, on
the CPU: a sharded pass records ``shard.route`` and the one-card
clustering's span names, its routing counters are sane, a pass run again
after a lane overflow is counted, a one-shard engine records no
``shard.*`` key and the one-card path's keys and counts are as they were
before the sharded path was traced; and the device-side counter of
``utils/timing.py``."""

import functools
import io

import pytest
import torch

from hash10x_tpu_torch.engine import COUNTERS, Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import from_read_batch
from hash10x_tpu_torch.io.sim import SimConfig, simulate
from hash10x_tpu_torch.utils import timing

torch.set_num_threads(2)

SHARD_COUNTERS = ("shard.route_keys", "shard.route_slots",
                  "shard.sweep_retries")

# span -> the parents it may have on the sharded path
PARENTS = {
    "count": {None}, "filter": {None}, "incidence": {None},
    "cluster": {None}, "split": {None}, "report": {None},
    "lane": {"count"}, "lane.order": {"lane"}, "lane.batches": {"lane"},
    "lane.copy": {"lane"},
    "table.flush": {"count", "incidence", "cluster.cooccur"},
    "shard.route": {"count", "incidence", "cluster.cooccur"},
    "cluster.cooccur": {"cluster"}, "cluster.friends": {"cluster"},
    "cluster.edges": {"cluster"}, "cluster.round": {"cluster"},
    # host waits (``timing.wait``), under the span their work lies in
    "wait.lane.batches": {"lane.batches"}, "wait.count.overflow": {"count"},
    "wait.shard.step": {"count", "incidence"}, "wait.shard.table": {"count"},
    "wait.shard.host_sum": {"count", "incidence", "shard.route",
                            "cluster.cooccur", "cluster"},
    "wait.table.flush": {"table.flush"},
    "wait.table.segment_sum": {"table.flush", "cluster.cooccur.reduce"},
    "wait.table.compact": {"filter", "incidence", "cluster.friends"},
    "wait.filter.sharded": {"filter"},
    "wait.shard.counts": {"filter", "incidence", "split"},
    "wait.shard.route": {"shard.route"},
    "wait.shard.incidence": {"incidence", "cluster.cooccur", "report"},
    "wait.cluster.shift_join": {"cluster.cooccur", "cluster.edges"},
    "wait.cluster.cooccur": {"cluster.cooccur"},
    "wait.cluster.friends": {"cluster.friends"},
    "wait.cluster.edges": {"cluster.edges"},
    "wait.cluster.round": {"cluster.round"},
    "wait.cluster.canonical": {"cluster"},
    "wait.shard.molecules": {"split"}, "wait.split": {"split"},
    "wait.report": {"report"},
    **{f"wait.text.{s}": {"report"} for s in (
        "digits", "literal", "render", "emit", "place", "report")},
}

# the one-card pass's counters and span counts on this lane, as the
# program gave them before the sharded path recorded anything, and the
# host waits (the ``filter`` span and the ``wait.*`` keys) since they are
# recorded
ONE_CARD = {
    "cluster.cooccur.n": 1, "cluster.cooccur.reduce.n": 1,
    "cluster.edges.n": 1, "cluster.friends.n": 1, "cluster.n": 1,
    "cluster.round.n": 4, "cluster.uf_edges": 0, "cluster.uf_hooks": 0,
    "count.n": 1, "dispatches": 6, "flushes": 6,
    "graph_captures": 0, "incidence.n": 1, "lane.batches.n": 1,
    "lane.copy.n": 1, "lane.n": 1, "lane.order.n": 1, "lane_bytes": 57600,
    "lane_staged_bytes": 0, "report.n": 1, "sorted_keys": 628645,
    "split.n": 1, "step.n": 6, "table.flush.n": 6,
    "filter.n": 1, "host_waits": 167,
    "wait.cluster.canonical.n": 1, "wait.cluster.edges.n": 28,
    "wait.cluster.friends.n": 1, "wait.cluster.molecules.n": 1,
    "wait.cluster.round.n": 4, "wait.cluster.shift_join.n": 23,
    "wait.count.overflow.n": 1, "wait.incidence.code_of_pair.n": 8,
    "wait.incidence.finalize.n": 1, "wait.incidence.overflow.n": 1,
    "wait.lane.batches.n": 3, "wait.report.n": 2, "wait.split.n": 2,
    "wait.table.compact.n": 2, "wait.table.flush.n": 42,
    "wait.table.segment_sum.n": 21, "wait.text.digits.n": 8,
    "wait.text.emit.n": 1, "wait.text.literal.n": 4, "wait.text.place.n": 4,
    "wait.text.render.n": 2, "wait.text.report.n": 7}


@functools.lru_cache(maxsize=None)
def _fqb():
    r = simulate(SimConfig(genome_len=40_000, n_barcodes=24,
                           molecules_per_barcode=2, molecule_len=5_000,
                           reads_per_molecule=30, read_len=100, seed=3))
    return from_read_batch(r.reads, r.barcode_keys)


def _pass(n_shards=1, **kw):
    eng = Engine(EngineConfig(spec=HashSpec(k=17, w=7, seed=17),
                              table_bits=10, batch_reads=128,
                              flush_batches=4, min_count=2, max_count=40,
                              min_friend_share=4, n_shards=n_shards, **kw),
                 "cpu", log=None)
    fqb = _fqb()
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    eng.split()
    eng.report(io.StringIO())
    return eng


@pytest.mark.parametrize("n_shards", [2, 4])
def test_a_sharded_pass_records_its_spans(n_shards):
    eng = _pass(n_shards)
    stats = eng.stats
    for name in ("shard.route", "cluster.cooccur", "cluster.friends",
                 "cluster.edges", "cluster.round"):
        assert stats[f"{name}.n"] >= 1, name
    assert stats["cluster.round.n"] >= 2
    for r in eng.timer.spans():
        assert r["parent"] in PARENTS[r["name"]], r
    # the routing of the incidence's redistribution and transpose and of
    # the co-occurrence sweep, and on the CPU the steps' too
    parents = {r["parent"] for r in eng.timer.spans()
               if r["name"] == "shard.route"}
    assert parents == {"count", "incidence", "cluster.cooccur"}
    assert "shard.route.device_s" not in stats    # no stream on the CPU


@pytest.mark.parametrize("n_shards", [2, 4])
def test_route_counters(n_shards):
    stats = _pass(n_shards).stats
    assert set(SHARD_COUNTERS) <= set(stats)
    assert 0 < stats["shard.route_keys"] <= stats["shard.route_slots"]
    assert stats["shard.sweep_retries"] == 0
    assert stats["flushes"] == stats["table.flush.n"] > 0
    assert stats["sorted_keys"] > 0 and stats["dispatches"] > 0


def test_route_counters_repeat():
    a, b = _pass(4).stats, _pass(4).stats
    keep = [k for k in a if not k.endswith("_s")]
    assert {k: a[k] for k in keep} == {k: b[k] for k in keep}


def test_a_pass_run_again_after_a_lane_overflow_is_counted():
    eng = _pass(4, lane_capacity=64)
    assert eng.stats["shard.sweep_retries"] >= 1
    assert eng.cfg.lane_capacity >= 128
    # the labels are the one-card engine's
    assert torch.equal(eng.cluster_labels, _pass(1).cluster_labels)


def test_one_shard_records_no_shard_key():
    stats = _pass(1).stats
    assert not [k for k in stats if k.startswith("shard.")]


def test_the_one_card_stats_are_unchanged():
    stats = _pass(1).stats
    assert {k: v for k, v in stats.items() if not k.endswith("_s")} == \
        ONE_CARD
    assert set(stats) == set(ONE_CARD) | {
        k[:-2] + ".host_s" for k in ONE_CARD if k.endswith(".n")}
    assert set(COUNTERS) <= set(stats)


def test_reset_drops_the_shard_counters():
    eng = _pass(4)
    eng.reset()
    assert eng.stats == dict.fromkeys(COUNTERS, 0)


def test_a_device_counter_is_summed_and_read_with_the_counters():
    timer = timing.StageTimer(None)
    with timing.recording(timer):
        timing.add("shard.route_slots", 10)
        timing.add_device("shard.route_keys", torch.tensor(3))
        timing.add_device("shard.route_keys", torch.tensor([4]))
    timing.add_device("shard.route_keys", torch.tensor(100))  # no timer
    with timing.recording(None):
        timing.add_device("shard.route_keys", torch.tensor(100))
    assert timer.counter_totals() == {"shard.route_slots": 10,
                                      "shard.route_keys": 7}
    assert timer.stats() == timer.counter_totals()
    timer.clear()
    assert timer.stats() == {}
