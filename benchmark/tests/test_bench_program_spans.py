"""The readers of the program's own spans and counters (``Engine.stats``):
each reads its key as the mean over the window's passes, and returns None
where no pass has it, as on a program that records no such span."""

import pytest

from benchmark.run import _reader

# metric -> (the stats of two passes, the value read from them)
CASES = {
    "lane_s": ({"lane.host_s": 0.5}, {"lane.host_s": 0.7}, 0.6),
    "capture_s": ({"step.capture.host_s": 0.2},
                  {"step.capture.host_s": 0.4}, 0.3),
    "captures_per_pass": ({"graph_captures": 5}, {"graph_captures": 5}, 5),
    "dispatch_s": ({"step.host_s": 1.0, "step.capture.host_s": 0.25},
                   {"step.host_s": 2.0, "step.capture.host_s": 0.75}, 1.0),
    "flush_s": ({"table.flush.device_s": 0.1},
                {"table.flush.device_s": 0.3}, 0.2),
    "sorted_keys_per_pass": ({"sorted_keys": 10}, {"sorted_keys": 30}, 20),
    "cooccur_s": ({"cluster.cooccur.device_s": 0.5},
                  {"cluster.cooccur.device_s": 0.5}, 0.5),
    "edges_s": ({"cluster.edges.device_s": 0.4},
                {"cluster.edges.device_s": 0.6}, 0.5),
    "propagation_s": ({"cluster.round.device_s": 1.0},
                      {"cluster.round.device_s": 2.0}, 1.5),
}


def _ctx(*stats):
    return {"passes": [{"wall_s": 1.0, "spans": {}, "stats": s}
                       for s in stats]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_its_key(name):
    a, b, want = CASES[name]
    assert _reader(name)(_ctx(a, b)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_without_its_key_reads_none(name):
    # the parent's stats: the two counters it had, no span
    assert _reader(name)(_ctx({"dispatches": 197, "flushes": 82})) is None
    assert _reader(name)(_ctx()) is None


def test_dispatch_s_without_captures_is_the_step_time():
    assert _reader("dispatch_s")(_ctx({"step.host_s": 0.5})) == 0.5
