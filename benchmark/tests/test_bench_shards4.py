"""The four-shard cell (``chr20_30x_slice.shards4``) on its tiny copy: a
sound run is correct, untraced and traced, and its new metrics read what
the sharded path records; a run with the sharded path broken underneath
comes out not correct.  The runs skip the harness's look for a card and
drive the rest of a run on the CPU, where no stream clock runs: the
metrics of stream seconds are read on the card (``chip``)."""

import io

import pytest
import torch

import hash10x_tpu_torch.dist.sharded_sorted as SS
from benchmark import run as bench_run
from hash10x_tpu_torch.dist.group import ShardGroup

CPU = torch.device("cpu")
CELL = "chr20_30x_slice.shards4"
COUNTED = {"shard_route_fill", "shard_sweep_retries"}
TIMED = {"shard_route_s", "shard_cooccur_s", "shard_edges_s",
         "shard_propagation_s"}


def _run(root, trace=False, device=CPU):
    return bench_run.run_cell(CELL, 2**31 + 77, 0.5, trace, device,
                              root=root, log=io.StringIO())


def _sound(r):
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    assert set(r["checks"]) == {"band", "pairs", "labels", "molecules",
                                "report_lines"}


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny, trace):
    r = _run(tiny, trace)
    _sound(r)
    names = set(r["metrics"])
    if not trace:
        assert names == {"reads_per_s", "setup_s"}
        return
    assert names == COUNTED    # on the CPU no stream seconds
    assert 0 < r["metrics"]["shard_route_fill"]["value"] <= 100
    assert r["metrics"]["shard_sweep_retries"]["value"] == 0


def test_the_passes_record_the_sharded_spans(tiny, monkeypatch):
    """What the timed readers read is recorded, on the host clock here."""
    seen = []
    real = bench_run._reader

    def reader(name):
        read = real(name)

        def spy(ctx):
            seen.append(ctx["passes"][-1]["stats"])
            return read(ctx)
        return spy
    monkeypatch.setattr(bench_run, "_reader", reader)
    _sound(_run(tiny, True))
    stats = seen[-1]
    for span in ("shard.route", "cluster.cooccur", "cluster.edges",
                 "cluster.round"):
        assert stats[f"{span}.n"] >= 1 and stats[f"{span}.host_s"] > 0
    assert 0 < stats["shard.route_keys"] <= stats["shard.route_slots"]


def _min_not_merged(mp):
    """The propagation's all_reduce(min) merges nothing: it returns the
    first shard's part as it was given."""
    real = ShardGroup.all_reduce
    mp.setattr(ShardGroup, "all_reduce",
               lambda self, x, op="sum": x[0] if op == "min"
               else real(self, x, op))


def _one_shard_dropped(mp):
    """Every exchange of routed keys delivers nothing to shard 1."""
    real = SS._exchange

    def dropped(group, lanes, pad, S, width=None):
        out = real(group, lanes, pad, S, width)
        if group.lo <= 1 < group.hi:
            i = 1 - group.lo
            out[i * S:(i + 1) * S] = pad
        return out
    mp.setattr(SS, "_exchange", dropped)


@pytest.mark.parametrize("fault", [_min_not_merged, _one_shard_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(tiny, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(tiny)
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.chip
def test_the_tiny_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(tiny, True, torch.device("cuda", 0))
    _sound(r)
    m = r["metrics"]
    assert COUNTED | TIMED <= set(m)
    assert all(m[k]["value"] > 0 for k in TIMED)
    assert 0 < m["shard_route_fill"]["value"] <= 100
