"""The spans and counters the port records inside itself
(``utils/timing.py``, exported per pass through ``Engine.stats``), on the
CPU over a small lane through count, filter, incidence and cluster: every
key is exported, each span under its parent, reset zeroes them, the step
and flush counts equal the calls made, the sort count repeats, nothing
records outside an engine, and under ``torch.profiler`` the spans lie
inside the caller's ``stage:`` range; and, on a CUDA card, the stream
seconds, the graph captures and the counters a replay adds."""

import functools
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hash10x_tpu_torch.engine import COUNTERS, Engine, EngineConfig
from hash10x_tpu_torch.hashspec import HashSpec
from hash10x_tpu_torch.io.fqb import from_read_batch
from hash10x_tpu_torch.io.sim import SimConfig, simulate
from hash10x_tpu_torch.table import sorted_table as st
from hash10x_tpu_torch.utils import timing

torch.set_num_threads(2)

# span -> the parents it may have
PARENTS = {
    "count": {None}, "incidence": {None}, "cluster": {None},
    "lane": {"count"}, "lane.order": {"lane"}, "lane.batches": {"lane"},
    "lane.copy": {"lane"},
    "step": {"count", "incidence"}, "table.flush": {"count", "incidence"},
    "cluster.cooccur": {"cluster"},
    "cluster.cooccur.reduce": {"cluster.cooccur"},
    "cluster.friends": {"cluster"}, "cluster.edges": {"cluster"},
    "cluster.round": {"cluster"},
}


@functools.lru_cache(maxsize=None)
def _fqb():
    r = simulate(SimConfig(genome_len=40_000, n_barcodes=24,
                           molecules_per_barcode=2, molecule_len=5_000,
                           reads_per_molecule=30, read_len=100, seed=3))
    return from_read_batch(r.reads, r.barcode_keys)


def _engine(device="cpu"):
    return Engine(EngineConfig(spec=HashSpec(k=17, w=7, seed=17),
                               table_bits=10, batch_reads=128,
                               flush_batches=4, min_count=2, max_count=40,
                               min_friend_share=4), device, log=None)


def _pass(eng):
    fqb = _fqb()
    eng.count(fqb)
    eng.filter()
    eng.incidence(fqb)
    eng.cluster()
    return eng.stats


def test_every_key_is_exported():
    stats = _pass(_engine())
    want = set(COUNTERS) | {f"{n}.{k}" for n in PARENTS
                            for k in ("host_s", "n")}
    assert set(stats) == want            # no device_s on the CPU
    assert all(stats[f"{n}.n"] >= 1 for n in PARENTS)
    assert stats["lane.n"] == 1          # the incidence reuses the lane
    assert stats["cluster.round.n"] >= 2
    assert stats["lane_bytes"] > 0 and stats["graph_captures"] == 0
    assert all(v >= 0 for v in stats.values())


def test_parents_and_self_times():
    eng = _engine()
    _pass(eng)
    recs = eng.timer.spans()
    assert {r["name"] for r in recs} == set(PARENTS)
    for r in recs:
        assert r["parent"] in PARENTS[r["name"]], r
        assert r["self_s"] >= 0 and r["host_s"] >= r["self_s"]
        assert not r["name"].startswith("stage:")
    # a parent's host time covers its children's
    by = {(r["name"], r["parent"]): r for r in recs}
    lane = by[("lane", "count")]
    assert lane["host_s"] >= sum(by[(c, "lane")]["host_s"]
                                 for c in ("lane.order", "lane.batches",
                                           "lane.copy"))


def test_reset_zeroes_the_keys():
    eng = _engine()
    first = _pass(eng)
    eng.reset()
    assert eng.stats == dict.fromkeys(COUNTERS, 0)
    assert eng.timer.spans() == []
    again = _pass(eng)
    # the reset kept the lane on the device: no lane span, the same steps
    assert "lane.n" not in again and again["lane_bytes"] == 0
    assert again["step.n"] == first["step.n"] == again["dispatches"]


def test_counts_equal_the_calls_made(monkeypatch):
    calls = {"steps": 0, "flushes": 0, "flushed": 0}
    real_flush, real_step = st.flush_grow, Engine._step

    def flush(t, *a, **kw):
        if t.buf_n:
            calls["flushes"] += 1
            calls["flushed"] += t.buf_n
        return real_flush(t, *a, **kw)

    def step(self, *a, **kw):
        calls["steps"] += 1
        return real_step(self, *a, **kw)
    monkeypatch.setattr(st, "flush_grow", flush)
    monkeypatch.setattr(Engine, "_step", step)
    stats = _pass(_engine())
    assert stats["dispatches"] == calls["steps"] == stats["step.n"] > 1
    assert stats["flushes"] == calls["flushes"] == stats["table.flush.n"] > 1
    assert stats["sorted_keys"] >= calls["flushed"] > 0


def test_sorted_keys_repeat():
    a, b = _pass(_engine()), _pass(_engine())
    assert a["sorted_keys"] == b["sorted_keys"] > 0
    assert {k: v for k, v in a.items() if not k.endswith("host_s")} == \
        {k: v for k, v in b.items() if not k.endswith("host_s")}


def test_no_span_may_take_the_stage_prefix():
    with pytest.raises(ValueError):
        timing.StageTimer(None).span("stage:count")


def test_outside_an_engine_nothing_records():
    eng = _engine()
    eng.count(_fqb())
    before = eng.stats
    t = st.make_sorted_table(1 << 8, 1 << 8, "cpu")
    t = st.append(t, torch.arange(100, dtype=torch.int64))
    assert timing._current is None
    t = st.flush_grow(t)
    assert t.n_filled == 100 and eng.stats == before
    # and a timer made current records it
    timer = timing.StageTimer(None)
    t = st.append(t, torch.arange(50, dtype=torch.int64))
    with timing.recording(timer):
        st.flush_grow(t)
    assert timer.counters == {"flushes": 1, "sorted_keys": 50}
    assert timer.span_totals()["table.flush"]["n"] == 1


def test_spans_lie_inside_the_stage_range_under_the_profiler(tmp_path):
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("stage:count"):
            eng.count(_fqb())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    stage = [e for e in events if e["name"] == "stage:count"]
    assert len(stage) == 1
    a, b = stage[0]["ts"], stage[0]["ts"] + stage[0]["dur"]
    for name in ("count", "lane.order", "step", "table.flush"):
        got = [e for e in events if e["name"] == name]
        assert got, name
        assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in got)
    assert len([e for e in events if e["name"] == "step"]) == \
        eng.stats["step.n"]


@pytest.mark.chip
def test_on_the_card_stream_spans_resolve_and_replays_count():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cpu = _pass(_engine())
    eng = _engine(dev)
    pool0 = len(timing._FREE.get(eng.timer.device, []))
    first = _pass(eng)
    torch.cuda.synchronize(dev)
    got = eng.stats
    assert eng.timer._pending == []      # every event resolved at the read
    # only the spans a metric reads take the stream clock; none in a capture
    assert {k[:-len(".device_s")] for k in got if k.endswith(".device_s")} \
        == {"table.flush", "cluster.cooccur", "cluster.edges",
            "cluster.round"}
    assert all(got[k] >= 0 for k in got if k.endswith(".device_s"))
    assert got["table.flush.device_s"] > 0 and got["step.capture.n"] >= 1
    # graphs counted once per shape; a replay adds the dedup sorts it holds,
    # as the eager steps on the CPU count them
    assert got["graph_captures"] == got["step.capture.n"] >= 1
    for k in ("dispatches", "flushes", "sorted_keys", "lane_bytes"):
        assert got[k] == first[k] == cpu[k], k
    # a second pass: the graphs are cached, the sorts repeat, and it draws
    # its events from those the first pass gave back
    pool = len(timing._FREE[eng.timer.device])
    eng.reset()
    again = _pass(eng)
    torch.cuda.synchronize(dev)
    again = eng.stats
    assert again["graph_captures"] == 0 and "step.capture.n" not in again
    assert again["sorted_keys"] == got["sorted_keys"]
    assert eng.timer._pending == []
    assert len(timing._FREE[eng.timer.device]) - pool < pool - pool0
