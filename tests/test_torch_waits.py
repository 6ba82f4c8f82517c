"""The host waits the port records (``utils/timing.py``: ``timing.wait``,
the counter ``host_waits`` and the spans ``wait.<site>``), on the CPU: the
record itself, its absence without a timer, the key in ``Engine.stats``,
the JSONL stage line, and a small seeded lane through each traffic mix of
the benchmark (``benchmark/traffic``), where the counter is the sum of the
sites, repeats from pass to pass and holds the counts the code fixes.  On
a CUDA card the counter equals the synchronising calls that torch's
sync-debug mode reports over the same pass."""

import functools
import io
import json
import warnings

import numpy as np
import pytest
import torch

from benchmark.lane import make_lane
from benchmark.run import HERE
from hash10x_tpu_torch.engine import COUNTERS, Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import Fqb
from hash10x_tpu_torch.utils import timing
from hash10x_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)

# the slice's settings at a CPU test's size: 24 reads of 150 bp a barcode
# in one 3 kb molecule, 48 barcodes over 12 kb; two batches a step, so the
# tables flush often
LANE = dict(n_reads=1152, n_codes=48, genome_len=12_000, seed=2**31 + 2601,
            molecule=3_000, read_len=150, error_rate=0.0024,
            both_strands=True)
MIXES = ("main", "count", "pair", "capped", "shards4")
# the CPU's sizes of the mixes' engine settings: a cap that binds
ENGINE = {"capped": {"max_friends": 4}}


@functools.lru_cache(maxsize=None)
def _fqb():
    lane = make_lane(**LANE)
    return Fqb(packed=lane.packed, lengths=lane.lengths,
               barcode_ids=lane.barcode_ids,
               barcode_keys=np.arange(lane.n_codes, dtype=np.uint32),
               read_len=lane.read_len)


def _traffic(mix: str) -> dict:
    return json.loads((HERE / "traffic" / f"{mix}.json").read_text())


def _engine(mix: str, device="cpu") -> Engine:
    kw = {**_traffic(mix).get("engine", {}), **ENGINE.get(mix, {})}
    return Engine(EngineConfig(spec=HashSpec(k=21, w=11, seed=17),
                               table_bits=12, batch_reads=128,
                               flush_batches=2, min_count=2, max_count=64,
                               min_friend_share=2, **kw), device, log=None)


def _calls(eng: Engine, mix: str):
    """The engine calls of one pass of ``mix``, in order."""
    args = {"lane": _fqb(), "sink": io.StringIO()}
    for st in _traffic(mix)["stages"]:
        call = getattr(eng, st["call"])
        yield lambda: call(*[args[x] for x in st.get("args", ())])


def _pass(mix: str, device="cpu") -> Engine:
    eng = _engine(mix, device)
    for call in _calls(eng, mix):
        call()
    return eng


def _site_sum(stats: dict) -> int:
    return sum(v for k, v in stats.items()
               if k.startswith("wait.") and k.endswith(".n"))


def test_a_wait_counts_n_and_records_under_its_parent():
    t = StageTimer(None)
    with t.span("outer"):
        with timing.wait("site", 3):
            pass
        with timing.wait("site"):
            pass
        with t.span("inner"), timing.wait("other"):
            pass
    assert t.counters == {"host_waits": 5}
    by = {(r["name"], r["parent"]): r for r in t.spans()}
    assert by[("wait.site", "outer")]["n"] == 4
    assert by[("wait.other", "inner")]["n"] == 1
    assert "device_s" not in by[("wait.site", "outer")]
    # a wait's time is its parent's child time, not its self time
    outer = by[("outer", None)]
    assert outer["host_s"] - outer["self_s"] >= \
        by[("wait.site", "outer")]["host_s"]
    stats = t.stats()
    assert stats["wait.site.n"] == 4 and stats["wait.other.n"] == 1
    assert stats["wait.site.host_s"] >= 0 and stats["host_waits"] == 5


def test_a_wait_records_nothing_without_a_timer():
    assert timing._current is None
    t = StageTimer(None)
    with timing.wait("site", 2):
        pass
    with timing.recording(t), timing.recording(None), timing.wait("site"):
        pass
    assert t.counters == {} and t.spans() == []
    with timing.recording(t), timing.wait("site"):
        pass
    assert t.counters == {"host_waits": 1}
    assert t.spans()[0]["parent"] is None


def test_host_waits_is_in_a_fresh_engines_stats_at_zero():
    assert "host_waits" in COUNTERS
    eng = _engine("main")
    assert eng.stats["host_waits"] == 0
    assert not [k for k in eng.stats if k.startswith("wait.")]


def test_the_jsonl_stage_line_carries_the_waits(tmp_path):
    path = tmp_path / "metrics.jsonl"
    eng = _engine("main")
    eng.timer = StageTimer(None, str(path))
    eng.count(_fqb())
    eng.filter()
    eng.timer.close()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["stage"].split(":")[0] for r in recs] == \
        ["count", "filter [2,64]"]
    count, filt = recs
    assert count["counters"]["host_waits"] == _site_sum(
        {f"{k}.n": v["n"] for k, v in count["spans"].items()
         if k.startswith("wait.")}) > 0
    assert count["spans"]["wait.table.flush"]["n"] > 0
    assert count["spans"]["wait.lane.batches"]["n"] == 3
    assert filt["counters"] == {"host_waits": 2}
    assert filt["spans"]["wait.table.compact"]["n"] == 2


@pytest.mark.parametrize("mix", MIXES)
def test_each_mix_counts_its_sites_the_same_on_every_pass(mix):
    a, b = _pass(mix), _pass(mix)
    sa, sb = a.stats, b.stats
    assert sa["host_waits"] == _site_sum(sa) > 0
    assert {k: v for k, v in sa.items() if k.startswith("wait.")
            and k.endswith(".n")} == \
        {k: v for k, v in sb.items() if k.startswith("wait.")
         and k.endswith(".n")}
    assert sa["host_waits"] == sb["host_waits"]
    # every wait lies under a span of the engine's
    assert all(r["parent"] is not None for r in a.timer.spans()
               if r["name"].startswith("wait."))


@pytest.mark.parametrize("mix", ("main", "count", "shards4"))
def test_a_flush_waits_ten_times(mix):
    """The flush's waits: the segment sum's run count and two selections,
    the found keys' two selections, the new keys' three and the bincount
    of their places (two reads)."""
    eng = _pass(mix)
    under = [r for r in eng.timer.spans() if r["parent"] == "table.flush"]
    assert {r["name"] for r in under} == {"wait.table.flush",
                                          "wait.table.segment_sum"}
    assert sum(r["n"] for r in under) == 10 * eng.stats["flushes"] > 0


def test_pair_mode_reads_its_ranks_once_a_batch():
    stats = _pass("pair").stats
    assert stats["wait.cluster.pair.ranks.n"] == \
        stats["cluster.pair.lists.n"] > 0
    # the batch's ids sent, its labels put in place; the CPU's rounds a
    # read each
    assert stats["wait.cluster.batch.n"] == 3 * stats["cluster.pair.lists.n"]
    assert stats["wait.cluster.rounds.n"] == stats["cluster.pair_rounds"]


def test_capped_mode_waits_once_a_round_and_three_times_a_batch():
    stats = _pass("capped").stats
    assert stats["wait.cluster.batch.n"] == \
        3 * stats["cluster.capped.member.n"] > 0
    assert stats["wait.cluster.rounds.n"] == stats["cluster.capped_rounds"]


def _sync_warnings(fn) -> int:
    """The synchronising calls torch's sync-debug mode reports in
    ``fn()``.  The mode is turned on before the count starts: the first
    time a process turns it on, torch reports one synchronising call of
    its own."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing" in str(w.message) for w in got)


@pytest.mark.chip
@pytest.mark.parametrize("mix", MIXES)
def test_on_the_card_host_waits_are_the_synchronisations(mix):
    """``host_waits`` of a pass equals the synchronising calls torch
    reports during its engine calls, and the CPU's count less its
    rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    _pass(mix, dev)   # kernels built, graphs' stream made
    torch.cuda.synchronize(dev)
    eng = _engine(mix, dev)
    n = sum(_sync_warnings(call) for call in _calls(eng, mix))
    torch.cuda.synchronize(dev)
    assert eng.stats["host_waits"] == n > 0
    # the CPU waits at the same statements, and once more a round where
    # the card runs a union-find kernel
    cpu = _pass(mix).stats
    rounds = sum(cpu.get(f"wait.{s}.n", 0)
                 for s in ("cluster.round", "cluster.rounds"))
    assert cpu["host_waits"] - rounds == n
