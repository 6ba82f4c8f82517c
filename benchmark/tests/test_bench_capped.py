"""The capped cell (``chr20_30x_slice.capped``) on its tiny copy: a sound run
is correct, untraced and traced, and its new metrics read what the capped
path records; a run with the capped path broken underneath comes out not
correct, and so does the control.  Faults of the cap itself show only
where the cap binds: on a tiny copy whose configuration and mix keep 3
friends a barcode.  The runs skip the harness's look for a card and drive
the rest of a run on the CPU, where no stream clock runs: the metrics of
stream seconds are read on the card (``chip``)."""

import io
import json

import pytest
import torch

import hash10x_tpu_torch.cluster.cooccur as CO
import hash10x_tpu_torch.cluster.sparse as sparse
from benchmark import run as bench_run
from benchmark.control import control_readings
from benchmark.lane import lane_of
from benchmark.program import System

CPU = torch.device("cpu")
CELL = "chr20_30x_slice.capped"
COUNTED = {"capped_rounds", "capped_cell_fill"}
TIMED = {"capped_friends_s", "capped_member_s", "capped_propagation_s"}
CHECKS = {"band", "pairs", "labels", "molecules", "report_lines"}
SEED = 2**31 + 77
BINDING_CAP = 3


def _run(root, trace=False, device=CPU):
    return bench_run.run_cell(CELL, SEED, 0.5, trace, device, root=root,
                              log=io.StringIO())


def _sound(r):
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c == {"value": 0, "limit": 0} for c in r["checks"].values())
    assert set(r["checks"]) == CHECKS


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(tiny, trace):
    r = _run(tiny, trace)
    _sound(r)
    names = set(r["metrics"])
    if not trace:
        assert names == {"reads_per_s", "setup_s"}
        return
    assert names == COUNTED    # on the CPU no stream seconds
    assert 0 < r["metrics"]["capped_cell_fill"]["value"] <= 100
    assert r["metrics"]["capped_rounds"]["value"] >= 1


def test_the_mix_runs_the_configurations_contract(tiny):
    _, _, cfg, traffic = bench_run.load_cell(CELL, tiny)
    assert traffic["engine"] == {k: cfg[k]
                                 for k in ("cluster_mode", "max_friends")}
    assert cfg["max_friends"] == 256 and cfg["min_friend_share"] == 8
    assert traffic["reference"] == "capped_molecules"


@pytest.fixture
def binding(tiny, monkeypatch):
    """The tiny copy with its configuration and mix at a cap of 3, which
    binds for every barcode of its lane."""
    path = tiny / "benchmark/configs/chr20_30x_slice_capped.json"
    cfg = json.loads(path.read_text())
    cfg["max_friends"] = BINDING_CAP
    path.write_text(json.dumps(cfg))
    real = bench_run.load_cell

    def load_cell(*a, **kw):
        manifest, cell, cfg, traffic = real(*a, **kw)
        traffic["engine"] = dict(traffic["engine"],
                                 max_friends=cfg["max_friends"])
        return manifest, cell, cfg, traffic
    monkeypatch.setattr(bench_run, "load_cell", load_cell)
    return tiny


def test_the_cap_binds_on_the_binding_copy(binding):
    _, _, cfg, traffic = bench_run.load_cell(CELL, binding)
    p = System(cfg, traffic, lane_of(cfg, SEED), CPU).run_pass()
    assert p.stats["cluster.capped_cut"] == p.engine.inc.n_codes
    _sound(_run(binding))


def _one_round(mp):
    """Propagation stops after its first round."""
    def once(step, valid):
        K = valid.shape[1]
        iota = torch.arange(K, device=valid.device)
        return step(torch.where(valid, iota, K)), 1
    mp.setattr(CO, "_propagate", once)


def _threshold_off_by_one(mp):
    """A barcode is a friend only at one more shared k-mer than the
    contract asks."""
    real = CO.friends_table
    mp.setattr(CO, "friends_table",
               lambda inc, thr, max_friends, pad=False: real(
                   inc, thr + 1, max_friends, pad))


def _cap_off_by_one(mp):
    """Each barcode keeps one friend fewer than the cap."""
    real = CO.friends_table
    mp.setattr(CO, "friends_table",
               lambda inc, thr, max_friends, pad=False: real(
                   inc, thr, max_friends - 1, pad))


def _ties_to_the_larger_id(mp):
    """Friends of equal share are ranked larger id first."""
    def table(inc, thr, max_friends, pad=False):
        n = inc.n_codes
        keys, shares = sparse.cooccurrence_counts(inc)
        c1, c2 = keys // n, keys % n
        code, friend = torch.cat([c1, c2]), torch.cat([c2, c1])
        share = torch.cat([shares, shares])
        ok = share >= thr
        code, friend, share = code[ok], friend[ok], share[ok]
        o = torch.argsort(code * n + (n - 1 - friend))
        o = o[torch.argsort(-share[o], stable=True)]
        o = o[torch.argsort(code[o], stable=True)]
        code, friend = code[o], friend[o]
        per = torch.bincount(code, minlength=n)
        rank = (torch.arange(code.shape[0])
                - (torch.cumsum(per, 0) - per)[code])
        keep = rank < max_friends
        out = torch.full((n, max_friends), -1, dtype=torch.int64)
        out[code[keep], rank[keep]] = friend[keep]
        return out
    mp.setattr(CO, "friends_table", table)


@pytest.mark.parametrize("fault", [_one_round, _threshold_off_by_one],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_is_not_correct(tiny, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(tiny)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["labels"]["value"] > 0


@pytest.mark.parametrize("fault", [_cap_off_by_one, _ties_to_the_larger_id],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_of_the_cap_is_not_correct(binding, fault,
                                                   monkeypatch):
    fault(monkeypatch)
    r = _run(binding)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["labels"]["value"] > 0


def test_the_control_fails(tiny):
    _, _, cfg, traffic = bench_run.load_cell(CELL, tiny)
    got = control_readings(cfg, traffic, 2**31 + 5, CPU)
    assert set(got) == CHECKS and got["band"] > 0 and got["pairs"] > 0


@pytest.mark.chip
def test_the_tiny_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _run(tiny, True, torch.device("cuda", 0))
    _sound(r)
    m = r["metrics"]
    assert COUNTED | TIMED <= set(m)
    assert all(m[k]["value"] > 0 for k in COUNTED | TIMED)
    assert m["capped_cell_fill"]["value"] <= 100
